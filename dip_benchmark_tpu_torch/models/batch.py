"""Batch image processing: the fused pipeline, one op or a fused op chain
over image stacks and directories, the serving path.

The port of ``dip_benchmark_tpu/models/batch.py`` for one device. A stack
of same-sized images is copied to the card as it is, image by image
through page-locked memory, and baked there into one ``(B, 3, Hp, pitch)``
planar tensor by one ``bake_u8`` launch (``ops/layout.py``); the CPU
backend bakes it in NumPy (``utils/image.stack_planar_padded``). The
result comes back planar and is cropped on the host. The fused pipeline
runs the whole stack in one ``pipeline_u8`` launch (``blockIdx.z`` is the
image), and a chain of ops (``--op A,B,...``, ``models/chain.py``) in one
``chain_u8`` launch, on a layout whose halo is the chain's radius (at
least 2). A single op of the matrix runs on the library path, as the JAX
package runs it vmapped on XLA: ``ops.library.IMAGE_OPS[op]`` once on the
whole ``(B, H, W, 3)`` stack, which is copied to the card as it is, with
no layout bake and no crop.

With ``--shards N --data-shards D`` a chain, and the pipeline as the
chain ``PIPELINE_COLS``, runs on a ``(data, space)`` mesh of D x N shards
(``parallel/``): the stack's images split over the data axis, their rows
over the space axis, each shard one batched chain launch on its resident
stack with the chain's halo refreshed from its neighbours. Rows are
mirror-padded so the shards divide them and carry the chain's halo; the
batch is padded to the data axis by repeating its last image; both are
cropped on fetch.

    python -m dip_benchmark_tpu_torch.models.batch <indir> <outdir> \\
        [--op Fused-Pipeline | --op A,B,...] [--batch-size B] \\
        [--shards N [--data-shards D]] [--backend cuda|cpu]

Exit codes: 0 ok, 2 refused arguments (an unknown op, a chain that
``chain.check_chain`` refuses, ``--shards`` with a single op,
``--data-shards`` without ``--shards``), 4 no CUDA device for ``--backend
cuda``.
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
from ..ops import kernels, library
from ..ops.layout import bake_stack
from ..parallel.halo import Mesh, make_mesh
from ..parallel.kernel_ops import chain_row_padding, sharded_kernel_chain
from ..runtime import DeviceGateError, gate_backend, tracing
from ..utils.image import (PlanarLayout, from_planar_padded,
                           from_resident_planar, is_image_file, load_image,
                           make_layout, save_image, stack_planar_padded,
                           to_resident_planar)
from . import chain
from .pipeline import fused_pipeline

# What --op accepts: the 12 device ops of the matrix and the pipeline.
COLUMNS = tuple(c for c in spec.CSV_COLUMNS
                if c not in ("Upload", "Download")) + ("Fused-Pipeline",)
# The fused pipeline as a chain: what a mesh runs for it.
PIPELINE_COLS = ("Grayscale", "Threshold", "Erosion-3x3-Square",
                 "Gaussian-Blur-3x3")


class _Token(NamedTuple):
    """A dispatched batch. On the card, ``result`` is a pinned host tensor
    that is complete once ``done`` has fired; ``source`` keeps the pinned
    input alive until its copy to the card has run. ``layout`` is None
    for a library op, whose result is the ``(B, H, W, 3)`` stack."""
    layout: PlanarLayout | None
    result: torch.Tensor
    done: torch.cuda.Event | None
    source: torch.Tensor


class _ShardedToken(NamedTuple):
    """A batch dispatched over a mesh: the resident output blocks in mesh
    order (pinned host copies on the card, with an event a device; the
    pinned inputs kept alive until their copies ran), the per-shard
    layout, and what the crop needs: the image height, the batch before
    padding and the mesh."""
    layout: PlanarLayout
    results: tuple
    done: tuple
    sources: tuple
    height: int
    batch: int
    mesh: Mesh


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


@functools.lru_cache(maxsize=64)
def _sharded_chain(mesh: Mesh, cols: tuple[str, ...], height: int,
                   width: int, batch: int):
    """One sharded chain per geometry (its descriptors go to each device
    once): the op and the per-shard layout."""
    return sharded_kernel_chain(mesh, list(cols), height, width, batch=batch)


def _dispatch_sharded_chain(images: np.ndarray, cols: tuple[str, ...],
                            mesh: Mesh) -> _ShardedToken:
    """The chain over the mesh's ``(data, space)`` shards, each a batched
    chain launch on its resident stack. Rows are mirror-padded by the
    sharded session's rule (``kernel_ops.chain_row_padding``); the batch
    is padded to the data axis by repeating the last image."""
    b, h, w, _ = images.shape
    n_space, n_data = mesh.n_space, mesh.n_data
    pad = chain_row_padding(h, n_space, cols)
    if pad > h:
        raise ValueError(
            f"{h}-row images are too small for a chain needing "
            f"{max(2, *chain.check_chain(cols))}-row halos over {n_space} "
            f"row shards")
    bpad = (-b) % n_data
    stack = images
    if bpad:
        stack = np.concatenate([stack, np.repeat(stack[-1:], bpad, axis=0)])
    if pad:
        stack = np.concatenate([stack, stack[:, h - pad:][:, ::-1]], axis=1)
    op, layout = _sharded_chain(mesh, cols, h + pad, w, b + bpad)
    with tracing.span("bake"):
        resident = to_resident_planar(np.transpose(stack, (0, 3, 1, 2)),
                                      layout, n_space)
    b_loc = (b + bpad) // n_data
    sources = tuple(resident[s][d * b_loc:(d + 1) * b_loc]
                    for d in range(n_data) for s in range(n_space))
    devices = mesh.flat
    on_card = devices[0].type == "cuda"
    if on_card:
        sources = tuple(src.pin_memory() for src in sources)
    outs = op(tuple(src.to(dev, non_blocking=True)
                    for src, dev in zip(sources, devices)))
    if not on_card:
        return _ShardedToken(layout, outs, (), sources, h, b, mesh)
    with tracing.span("pin_alloc"):
        results = tuple(torch.empty(out.shape, dtype=out.dtype,
                                    pin_memory=True) for out in outs)
    for result, out in zip(results, outs):
        result.copy_(out, non_blocking=True)
    done = []
    for dev in mesh.distinct:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
        done.append(event)
    return _ShardedToken(layout, results, tuple(done), sources, h, b, mesh)


def _upload_and_bake(images: np.ndarray, layout: PlanarLayout,
                     device: torch.device) -> tuple[torch.Tensor, ...]:
    """The stack's images copied one by one into a page-locked ``(B, H, W,
    3)`` buffer, each copied on to the card as soon as it is there (the
    host's copy of image i + 1 overlaps the card's copy of image i), then
    baked on the card (``ops.layout.bake_stack``). Returns the page-locked
    buffer, which has to live until its copies have run, and the planar
    stack on the card. The host's copies are ``Tensor.copy_``, which
    splits a copy over the intra-op threads, where a NumPy copy takes one
    core (on the H100's host 17-24 GB/s against 4-6, and 6-8 for one
    pageable upload of the stack; ``benchmarks/h100/bake_lab.py``)."""
    with tracing.span("pin_alloc"):
        staging = torch.empty(images.shape, dtype=torch.uint8,
                              pin_memory=True)
    with tracing.span("alloc"):
        raw = torch.empty(images.shape, dtype=torch.uint8, device=device)
    for i, image in enumerate(images):
        staging[i].copy_(torch.from_numpy(np.ascontiguousarray(image)))
        raw[i].copy_(staging[i], non_blocking=True)
    return staging, bake_stack(raw, layout)


def _dispatch_batch(images: np.ndarray, csv_column, device):
    """Queue one batch; returns a token for ``_fetch_batch``. On the card
    everything after the host's copies into pinned memory is asynchronous:
    the copies in, the layout bake and the other launches, and the copy out
    into pinned memory, so the caller can fetch and encode the previous
    batch meanwhile.
    ``csv_column`` is one of ``COLUMNS`` or a list of columns, a chain.
    ``device`` is a ``torch.device``, or a ``Mesh`` to shard a chain or
    the pipeline over."""
    _check_stack(images)
    if isinstance(device, Mesh):
        if csv_column == "Fused-Pipeline":
            return _dispatch_sharded_chain(images, PIPELINE_COLS, device)
        if not isinstance(csv_column, (list, tuple)):
            raise ValueError("--shards applies to chain/pipeline ops only")
        return _dispatch_sharded_chain(images, tuple(csv_column), device)
    b, h, w, _ = images.shape
    if isinstance(csv_column, (list, tuple)):
        cols = tuple(csv_column)
        layout = make_layout(h, w, pad=max(2, *chain.check_chain(cols)))
    elif csv_column == "Fused-Pipeline":
        layout = make_layout(h, w)
    elif csv_column in COLUMNS:
        layout = None
    else:
        raise ValueError(f"no batch op {csv_column!r}; one of {COLUMNS} "
                         f"or a list of them")
    on_card = device.type == "cuda"
    if layout is None:
        source = torch.from_numpy(np.ascontiguousarray(images))
        if on_card:
            source = source.pin_memory()
        stack = source.to(device, non_blocking=True) if on_card else source
    elif on_card:
        with tracing.span("bake"):
            source, stack = _upload_and_bake(images, layout, device)
    else:
        with tracing.span("bake"):
            source = stack = stack_planar_padded(images, layout)
    if isinstance(csv_column, (list, tuple)):
        outs = _batched_chain(layout, cols, b)(stack)
    elif csv_column == "Fused-Pipeline":
        outs = fused_pipeline(stack)
    else:
        outs = library.IMAGE_OPS[csv_column](stack)
    if not on_card:
        return _Token(layout, outs, None, source)
    with tracing.span("pin_alloc"):
        result = torch.empty(outs.shape, dtype=torch.uint8, pin_memory=True)
    result.copy_(outs, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return _Token(layout, result, done, source)


def _fetch_batch(token) -> np.ndarray:
    """Wait for a dispatched batch; the uint8 (B, H, W, 3) result."""
    if isinstance(token, _ShardedToken):
        for event in token.done:
            event.synchronize()
        layout = token.layout
        with tracing.span("crop"):
            valid = np.concatenate([
                from_resident_planar(row, layout, layout.height, token.height)
                for row in token.mesh.rows(token.results)])[:token.batch]
            return np.ascontiguousarray(np.transpose(valid, (0, 2, 3, 1)))
    if token.done is not None:
        token.done.synchronize()
    if token.layout is None:
        return token.result.numpy()
    with tracing.span("crop"):
        return from_planar_padded(token.result, token.layout)


def _device(device) -> torch.device:
    """``device``, or the card when None (DeviceGateError without one)."""
    return gate_backend("cuda") if device is None else torch.device(device)


def process_batch(images: np.ndarray, csv_column="Fused-Pipeline",
                  device=None, mesh: Mesh | None = None) -> np.ndarray:
    """Run one op of ``COLUMNS``, or given a list of columns their fused
    chain, over a uint8 ``(B, H, W, 3)`` stack on ``device`` (default: the
    card), or a chain or the pipeline sharded over ``mesh``; returns the
    ``(B, H, W, 3)`` result. The call is the port's ``batch`` span, and
    counts its images under ``images`` (``runtime/tracing.py``)."""
    target = mesh if mesh is not None else _device(device)
    with tracing.span("batch"):
        out = _fetch_batch(_dispatch_batch(images, csv_column, target))
    tracing.count("images", len(out))
    return out


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
                      batch_size: int = 8, device=None,
                      mesh: Mesh | None = None) -> list[str]:
    """Process every image in ``indir`` into ``outdir`` under the same
    name, grouping same-shaped images into batches of up to
    ``batch_size``; ``csv_column``, ``device`` and ``mesh`` as for
    ``process_batch``. Returns the written paths.

    Serving-style overlap: chunk n is dispatched before chunk n - 1 is
    fetched and encoded, so host work on one chunk runs while the card
    works on the next."""
    device = mesh if mesh is not None else _device(device)
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
                   help="Shard image rows over N shards (chain/pipeline "
                        "ops only: the batched fused chain then runs on a "
                        "(data, space) mesh, halo rows refreshed between "
                        "neighbours; several shards may share a device)")
    p.add_argument("--data-shards", type=int, default=1, metavar="D",
                   help="Also shard the batch over D (needs --shards; N*D "
                        "shards in all)")
    p.add_argument("--backend", choices=["cuda", "cpu"], default="cuda",
                   help="Device: the CUDA kernels (default) or their plain "
                        "PyTorch versions on the host")
    args = p.parse_args(argv)

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
    if args.shards < 0 or args.data_shards < 1:
        print(f"--shards needs N >= 0 and --data-shards D >= 1, got "
              f"{args.shards}, {args.data_shards}", file=sys.stderr)
        return 2
    if args.shards:
        if not (isinstance(op, list) or op == "Fused-Pipeline"):
            print("--shards applies to chain/pipeline ops only",
                  file=sys.stderr)
            return 2
    elif args.data_shards != 1:
        print("--data-shards needs --shards", file=sys.stderr)
        return 2
    try:
        device = gate_backend(args.backend)
    except DeviceGateError as e:
        print(str(e), file=sys.stderr)
        return 4
    if device.type == "cuda":
        kernels.load()  # build before the first batch: set-up, not serving
    mesh = (make_mesh(args.shards, args.data_shards, backend=args.backend)
            if args.shards else None)
    written = process_directory(args.indir, args.outdir, op,
                                args.batch_size, device=device, mesh=mesh)
    print(f"Processed {len(written)} images -> {args.outdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
