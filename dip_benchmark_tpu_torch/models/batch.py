"""Batch image processing: the fused pipeline, one op or a fused op chain
over image stacks and directories, the serving path.

The port of ``dip_benchmark_tpu/models/batch.py`` for one device. Every
stack of same-sized images takes one route, on the card and on the CPU:
it is uploaded as it is (to the card image by image through page-locked
memory; on the CPU the array itself), baked into a ``(b, 3, Hp, pitch)``
planar tensor by ``ops/layout.bake_stack`` (one ``bake_u8`` launch on the
card, its plain version on the CPU), run, and cropped to ``(b, H, W, 3)``
by ``ops/layout.crop_stack`` (one ``crop_u8`` launch, or its plain
version); from the card only that comes back, into page-locked memory. On
the card a large stack runs in chunks of whole images (``chunks``: at
least ``CHUNK_BYTES`` a chunk), each chunk's copy back on a copy stream
of its own while the host stages the next chunk; a stack under the floor
is one chunk, as is every stack on the CPU. The fused pipeline runs a
chunk in one ``pipeline_u8`` launch (``blockIdx.z`` is the image), and a
chain of ops (``--op A,B,...``, ``models/chain.py``) in one ``chain_u8``
launch, on a layout whose halo is the chain's radius (at least 2). A
single op of the matrix runs on the library path, as the JAX package runs
it vmapped on XLA: ``ops.library.IMAGE_OPS[op]`` once on each chunk's
``(b, H, W, 3)`` stack, uploaded the same way, with no layout bake and no
crop.

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
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import spec
from ..ops import kernels, library
from ..ops.layout import bake_stack, crop_stack
from ..parallel.halo import Mesh, make_mesh
from ..parallel.kernel_ops import chain_row_padding, sharded_kernel_chain
from ..runtime import DeviceGateError, gate_backend, tracing
from ..utils.image import (PlanarLayout, from_resident_planar, is_image_file,
                           load_image, make_layout, save_image,
                           to_resident_planar)
from . import chain
from .pipeline import fused_pipeline

# What --op accepts: the 12 device ops of the matrix and the pipeline.
COLUMNS = tuple(c for c in spec.CSV_COLUMNS
                if c not in ("Upload", "Download")) + ("Fused-Pipeline",)
# The fused pipeline as a chain: what a mesh runs for it.
PIPELINE_COLS = ("Grayscale", "Threshold", "Erosion-3x3-Square",
                 "Gaussian-Blur-3x3")
# The least bytes of a chunk of a stack on the card (``chunks``): two
# 3504x2336 images (49.1 MB), 0.9 ms of PCIe each way. On the H100's host a
# chunk's launches and copy enqueues take 0.25-0.3 ms of the host's time
# (slowed by the staging copy before them), so against 16 MiB (one such
# image a chunk) two a chunk were faster in 5 of 6 in-turn comparisons
# (+3.5 % median), and either beat one chunk a stack by 10-14 % (stacks of
# 8 through the fused pipeline; ``benchmarks/h100/bake_lab.py``).
CHUNK_BYTES = 32 << 20


class _Token(NamedTuple):
    """A dispatched batch, on any route: the events to wait for (none on
    the CPU), the buffers that must live until the copies that read them
    have run (the host's staging, the card's outputs), and ``finish``,
    which gives the ``(B, H, W, 3)`` result once the events have fired."""
    done: tuple
    keep: tuple
    finish: Callable[[], np.ndarray]


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


def _download(outs: tuple, devices) -> tuple[tuple, tuple]:
    """Page-locked host copies of the card's ``outs``, enqueued, and an
    event after them on the current stream of each of ``devices``."""
    with tracing.span("pin_alloc"):
        results = tuple(torch.empty(out.shape, dtype=out.dtype,
                                    pin_memory=True) for out in outs)
    for result, out in zip(results, outs):
        result.copy_(out, non_blocking=True)
    return results, tuple(torch.cuda.current_stream(dev).record_event()
                          for dev in devices)


def _crop_blocks(blocks: tuple, layout: PlanarLayout, height: int,
                 batch: int, mesh: Mesh) -> np.ndarray:
    """A mesh's output blocks (mesh order, on the host) -> the ``(batch,
    height, W, 3)`` result: the rows' and the batch's padding cut off."""
    with tracing.span("crop"):
        valid = np.concatenate([
            from_resident_planar(row, layout, layout.height, height)
            for row in mesh.rows(blocks)])[:batch]
        return np.ascontiguousarray(np.transpose(valid, (0, 2, 3, 1)))


def _dispatch_sharded_chain(images: np.ndarray, cols: tuple[str, ...],
                            mesh: Mesh) -> _Token:
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
    done = ()
    if on_card:
        outs, done = _download(outs, mesh.distinct)
    return _Token(done, sources,
                  functools.partial(_crop_blocks, outs, layout, h, b, mesh))


def chunks(shape: tuple) -> tuple[tuple[int, int], ...]:
    """The ``(start, stop)`` image ranges, in order, that a ``(B, H, W,
    3)`` stack of ``shape`` runs in on the card: chunks of the fewest whole
    images whose bytes reach ``CHUNK_BYTES``, the last one shorter where
    they do not divide B. A stack under the floor is one chunk."""
    b, h, w, c = shape
    per = max(1, -(-CHUNK_BYTES // (h * w * c)))
    return tuple((i, min(i + per, b)) for i in range(0, b, per))


@functools.lru_cache(maxsize=None)
def _copy_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream that copies a batch's chunks back from ``device``: one a
    device, so a chunk's copy back runs on the card's second copy engine
    beside the next chunk's upload on the current stream."""
    return torch.cuda.Stream(device)


def _bake(stack: torch.Tensor, layout: PlanarLayout | None) -> torch.Tensor:
    return stack if layout is None else bake_stack(stack, layout)


def _run(stack: torch.Tensor, layout: PlanarLayout | None,
         op) -> torch.Tensor:
    """``op`` on a baked stack, cropped to ``(b, H, W, 3)`` on its
    device."""
    out = op(stack)
    if layout is None:
        return out
    with tracing.span("crop"):
        return crop_stack(out, layout)


def _dispatch_batch(images: np.ndarray, csv_column, device) -> _Token:
    """Queue one batch; returns a token for ``_fetch_batch``. On the card
    the stack runs in ``chunks``, each uploaded, baked, run, cropped and
    copied back before the next is staged: the host copies the chunk's
    images one by one into one page-locked ``(B, H, W, 3)`` staging stack,
    each copied on to the card as soon as it is there (the host's copy of
    image i + 1 overlaps the card's copy of image i); the chunk's launches
    follow on the current stream, and its copy back into one page-locked
    ``(B, H, W, 3)`` result waits for them on the device's copy stream, so
    it runs while the host stages the next chunk. Everything after the
    host's copies is asynchronous, so the caller can fetch and encode the
    previous batch meanwhile. The host's copies are ``Tensor.copy_``,
    which splits a copy over the intra-op threads, where a NumPy copy takes
    one core (on the H100's host 17-24 GB/s against 4-6, and 6-8 for one
    pageable upload of the stack; a whole-stack page-locked copy, then one
    upload, took 12.05 ms a stack of 8 where this loop took 7.43;
    ``benchmarks/h100/bake_lab.py``). On the CPU the stack is the array
    itself, one chunk. ``csv_column`` is one of ``COLUMNS`` or a list of
    columns, a chain. ``device`` is a ``torch.device``, or a ``Mesh`` to
    shard a chain or the pipeline over. The port's counter
    ``batch_chunks`` counts the chunks."""
    _check_stack(images)
    if isinstance(device, Mesh):
        if csv_column == "Fused-Pipeline":
            return _dispatch_sharded_chain(images, PIPELINE_COLS, device)
        if not isinstance(csv_column, (list, tuple)):
            raise ValueError("--shards applies to chain/pipeline ops only")
        return _dispatch_sharded_chain(images, tuple(csv_column), device)
    _, h, w, _ = images.shape
    if isinstance(csv_column, (list, tuple)):
        cols = tuple(csv_column)
        layout = make_layout(h, w, pad=max(2, *chain.check_chain(cols)))

        def op(stack):
            return _batched_chain(layout, cols, len(stack))(stack)
    elif csv_column == "Fused-Pipeline":
        layout, op = make_layout(h, w), fused_pipeline
    elif csv_column in COLUMNS:
        layout, op = None, library.IMAGE_OPS[csv_column]
    else:
        raise ValueError(f"no batch op {csv_column!r}; one of {COLUMNS} "
                         f"or a list of them")
    if device.type != "cuda":
        tracing.count("batch_chunks")
        with tracing.span("bake"):
            stack = _bake(torch.from_numpy(np.ascontiguousarray(images)),
                          layout)
        return _Token((), (), _run(stack, layout, op).numpy)
    with tracing.span("pin_alloc"):
        staging = torch.empty(images.shape, dtype=torch.uint8,
                              pin_memory=True)
        result = torch.empty(images.shape, dtype=torch.uint8,
                             pin_memory=True)
    with tracing.span("alloc"):
        raw = torch.empty(images.shape, dtype=torch.uint8, device=device)
    compute, copier = torch.cuda.current_stream(device), _copy_stream(device)
    bounds = chunks(images.shape)
    tracing.count("batch_chunks", len(bounds))
    outs = []
    for start, stop in bounds:
        with tracing.span("bake"):
            for i in range(start, stop):
                staging[i].copy_(torch.from_numpy(
                    np.ascontiguousarray(images[i])))
                raw[i].copy_(staging[i], non_blocking=True)
            stack = _bake(raw[start:stop], layout)
        # Kept in the token until the copy stream has read it.
        outs.append(_run(stack, layout, op))
        copier.wait_stream(compute)
        # set_stream, not the stream context manager: 2.9 µs against 17.5
        # on the H100's host.
        torch.cuda.set_stream(copier)
        try:
            result[start:stop].copy_(outs[-1], non_blocking=True)
        finally:
            torch.cuda.set_stream(compute)
    return _Token((copier.record_event(),), (staging, *outs), result.numpy)


def _fetch_batch(token: _Token) -> np.ndarray:
    """Wait for a dispatched batch; the uint8 (B, H, W, 3) result. From
    the card that is the token's pinned result itself, no copy: an array
    in page-locked memory from the host allocator's cache, which takes the
    buffer back once the array is dropped. The wait is the port's
    ``fetch`` span: the copy back that nothing hid."""
    if token.done:
        with tracing.span("fetch"):
            for event in token.done:
                event.synchronize()
    return token.finish()


def _device(device) -> torch.device:
    """``device``, or the card when None (DeviceGateError without one)."""
    return gate_backend("cuda") if device is None else torch.device(device)


def process_batch(images: np.ndarray, csv_column="Fused-Pipeline",
                  device=None, mesh: Mesh | None = None) -> np.ndarray:
    """Run one op of ``COLUMNS``, or given a list of columns their fused
    chain, over a uint8 ``(B, H, W, 3)`` stack on ``device`` (default: the
    card), or a chain or the pipeline sharded over ``mesh``; returns the
    ``(B, H, W, 3)`` result, which from the card lives in page-locked
    memory (``_fetch_batch``). The call is the port's ``batch`` span, and
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
