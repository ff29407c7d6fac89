"""Batch image processing: the fused pipeline, one op or a fused op chain
over image stacks and directories, the serving path.

The port of ``dip_benchmark_tpu/models/batch.py`` for one device. A stack
of same-sized images is baked into one ``(B, 3, Hp, pitch)`` planar tensor
on the host and copied to the card. The fused pipeline runs the whole
stack in one ``pipeline_u8`` launch (``blockIdx.z`` is the image), and a
chain of ops (``--op A,B,...``, ``models/chain.py``) in one ``chain_u8``
launch, on a layout whose halo is the chain's radius (at least 2); a
single op of the matrix runs its kernel (``ops.OPS``) once per image of
the stack. The JAX package runs single ops through its vmapped XLA path
instead, which the port does not have yet: the outputs are the same
function.

    python -m dip_benchmark_tpu_torch.models.batch <indir> <outdir> \\
        [--op Fused-Pipeline | --op A,B,...] [--batch-size B] \\
        [--backend cuda|cpu]

Exit codes: 0 ok, 2 refused arguments (an unknown op, a chain that
``chain.check_chain`` refuses, ``--shards``), 4 no CUDA device for
``--backend cuda``.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
from typing import NamedTuple

import numpy as np
import torch

from .. import spec
from ..ops import OPS, kernels
from ..runtime import DeviceGateError, gate_backend
from ..utils.image import (PlanarLayout, from_planar_padded, is_image_file,
                           load_image, make_layout, save_image,
                           stack_planar_padded)
from . import chain
from .pipeline import fused_pipeline

# What --op accepts: the 12 device ops of the matrix and the pipeline.
COLUMNS = tuple(c for c in spec.CSV_COLUMNS
                if c not in ("Upload", "Download")) + ("Fused-Pipeline",)


class _Token(NamedTuple):
    """A dispatched batch. On the card, ``result`` is a pinned host tensor
    that is complete once ``done`` has fired; ``source`` keeps the pinned
    input alive until its copy to the card has run."""
    layout: PlanarLayout
    result: torch.Tensor
    done: torch.cuda.Event | None
    source: torch.Tensor


def _check_stack(images: np.ndarray) -> None:
    if (getattr(images, "dtype", None) != np.uint8
            or getattr(images, "ndim", 0) != 4 or images.shape[3] != 3
            or len(images) == 0):
        raise ValueError(
            f"expected a non-empty uint8 (B, H, W, 3) stack, got "
            f"dtype={getattr(images, 'dtype', type(images))} "
            f"shape={getattr(images, 'shape', '?')}")


@functools.lru_cache(maxsize=64)
def _batched_chain(layout: PlanarLayout, cols: tuple[str, ...],
                   b: int) -> chain.FusedChain:
    """One chain per geometry, so its descriptor goes to the card once,
    not once a batch."""
    return chain.make_fused_chain(layout, list(cols), batch=b)


def _dispatch_batch(images: np.ndarray, csv_column,
                    device: torch.device) -> _Token:
    """Queue one batch; returns a token for ``_fetch_batch``. On the card
    everything after the host's layout bake is asynchronous: the copy in
    from pinned memory, the launches and the copy out into pinned memory,
    so the caller can fetch and encode the previous batch meanwhile.
    ``csv_column`` is one of ``COLUMNS`` or a list of columns, a chain."""
    _check_stack(images)
    b, h, w, _ = images.shape
    if isinstance(csv_column, (list, tuple)):
        cols = tuple(csv_column)
        layout = make_layout(h, w, pad=max(2, *chain.check_chain(cols)))
    elif csv_column in COLUMNS:
        layout = make_layout(h, w)
    else:
        raise ValueError(f"no batch op {csv_column!r}; one of {COLUMNS} "
                         f"or a list of them")
    on_card = device.type == "cuda"
    source = stack_planar_padded(images, layout, pin_memory=on_card)
    stack = source.to(device, non_blocking=True) if on_card else source
    if isinstance(csv_column, (list, tuple)):
        outs = _batched_chain(layout, cols, b)(stack)
    elif csv_column == "Fused-Pipeline":
        outs = fused_pipeline(stack)
    else:
        outs = torch.stack([OPS[csv_column](planar) for planar in stack])
    if not on_card:
        return _Token(layout, outs, None, source)
    result = torch.empty(outs.shape, dtype=torch.uint8, pin_memory=True)
    result.copy_(outs, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return _Token(layout, result, done, source)


def _fetch_batch(token: _Token) -> np.ndarray:
    """Wait for a dispatched batch; the uint8 (B, H, W, 3) result."""
    if token.done is not None:
        token.done.synchronize()
    return from_planar_padded(token.result, token.layout)


def _device(device) -> torch.device:
    """``device``, or the card when None (DeviceGateError without one)."""
    return gate_backend("cuda") if device is None else torch.device(device)


def process_batch(images: np.ndarray, csv_column="Fused-Pipeline",
                  device=None) -> np.ndarray:
    """Run one op of ``COLUMNS``, or given a list of columns their fused
    chain, over a uint8 ``(B, H, W, 3)`` stack on ``device`` (default: the
    card); returns the ``(B, H, W, 3)`` result."""
    return _fetch_batch(_dispatch_batch(images, csv_column, _device(device)))


def _probe_shape(path: str) -> tuple:
    """Shape of an image from its header, without decoding it; load_image
    always yields RGB HWC, so channels are 3 whatever the file's mode."""
    try:
        from PIL import Image
        with Image.open(path) as im:
            w, h = im.size
        return (h, w, 3)
    except (ImportError, OSError):
        return load_image(path).shape


def process_directory(indir: str, outdir: str,
                      csv_column="Fused-Pipeline",
                      batch_size: int = 8, device=None) -> list[str]:
    """Process every image in ``indir`` into ``outdir`` under the same
    name, grouping same-shaped images into batches of up to
    ``batch_size``; ``csv_column`` as for ``process_batch``. Returns the
    written paths.

    Serving-style overlap: chunk n is dispatched before chunk n - 1 is
    fetched and encoded, so host work on one chunk runs while the card
    works on the next."""
    device = _device(device)
    os.makedirs(outdir, exist_ok=True)
    by_shape: dict[tuple, list[tuple[str, str]]] = {}
    for name in sorted(os.listdir(indir)):
        path = os.path.join(indir, name)
        if is_image_file(path):
            by_shape.setdefault(_probe_shape(path), []).append((name, path))

    written: list[str] = []
    pending: tuple[list, _Token] | None = None

    def drain(p):
        group, token = p
        for (name, _), result in zip(group, _fetch_batch(token)):
            dst = os.path.join(outdir, name)
            save_image(dst, result)
            written.append(dst)

    for items in by_shape.values():
        for i in range(0, len(items), batch_size):
            # Decode per chunk, so memory holds about two chunks. The
            # header can disagree with the decoded shape (cv2 applies EXIF
            # orientation, the header does not), so regroup by the decoded
            # shape before stacking.
            decoded: dict[tuple, list[tuple[str, np.ndarray]]] = {}
            for name, path in items[i:i + batch_size]:
                image = load_image(path)
                decoded.setdefault(image.shape, []).append((name, image))
            for group in decoded.values():
                token = _dispatch_batch(np.stack([im for _, im in group]),
                                        csv_column, device)
                if pending is not None:
                    drain(pending)
                pending = (group, token)
    if pending is not None:
        drain(pending)
    return written


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        description="Apply the fused pipeline, one DIP op or a fused op "
                    "chain to every image in a directory, in batches")
    p.add_argument("indir")
    p.add_argument("outdir")
    p.add_argument("--op", default="Fused-Pipeline", metavar="OP[,OP...]",
                   help=f"one of {', '.join(COLUMNS)}, or a comma-separated "
                        "chain of device ops fused into one batched kernel "
                        "(models/chain.py rules apply)")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--shards", type=int, default=0, metavar="N",
                   help="row sharding, not ported yet: any N > 0 exits 2")
    p.add_argument("--data-shards", type=int, default=1, metavar="D",
                   help="batch sharding, not ported yet: any D other than "
                        "1 exits 2")
    p.add_argument("--backend", choices=["cuda", "cpu"], default="cuda",
                   help="Device: the CUDA kernels (default) or their plain "
                        "PyTorch versions on the host")
    args = p.parse_args(argv)

    if args.shards or args.data_shards != 1:
        print("--shards/--data-shards: row sharding is not ported yet",
              file=sys.stderr)
        return 2
    op = args.op
    if "," in op:
        op = [c.strip() for c in op.split(",") if c.strip()]
        try:  # validate the chain up front (fusability, order, radius)
            chain.check_chain(op)
        except ValueError as e:
            print(f"--op chain: {e}", file=sys.stderr)
            return 2
    elif op not in COLUMNS:
        print(f"--op must be one of {', '.join(COLUMNS)} or a "
              f"comma-separated chain", file=sys.stderr)
        return 2
    if args.batch_size < 1:
        print(f"--batch-size needs B >= 1, got {args.batch_size}",
              file=sys.stderr)
        return 2
    try:
        device = gate_backend(args.backend)
    except DeviceGateError as e:
        print(str(e), file=sys.stderr)
        return 4
    if device.type == "cuda":
        kernels.load()  # build before the first batch: set-up, not serving
    written = process_directory(args.indir, args.outdir, op,
                                args.batch_size, device=device)
    print(f"Processed {len(written)} images -> {args.outdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
