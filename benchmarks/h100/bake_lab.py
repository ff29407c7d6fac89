#!/usr/bin/env python3
"""The batch tool's layout bake on the card, timed on one GPU.

    python3 benchmarks/h100/bake_lab.py [--launches N] [--repeats R] \\
        [--variants NAME,...]

1. ``bake_u8`` (``ops/layout.bake_stack``) on a stack of ``BATCH`` seeded
   3504x2336 images: held byte-equal to ``utils/image.stack_planar_padded``,
   then the median device time of N launches from CUDA events
   (``chip_smoke.timed``; the 196 MB stack is four times the L2), against
   its bound: the stack read once and the planar stack written once at
   3.35 TB/s, 117.6 µs at B = 8; beside it the plain version
   (``bake_stack_plain``) on the card.
2. The upload of the same stack, host clock to a ``torch.cuda.synchronize``,
   R times each, in the order a b c d d c b a:
   a. per image: a NumPy copy into one page-locked ``(B, H, W, 3)``
      buffer, then that image's asynchronous copy to the card (what
      ``models/batch._upload`` does on the card);
   b. the same with ``Tensor.copy_`` for the host's copy;
   c. one ``torch.from_numpy(images).to(device)`` from pageable memory;
   d. one ``Tensor.copy_`` of the whole stack into the page-locked buffer,
      then one asynchronous copy of it to the card (no overlap of the
      host's copy with the card's).
3. ``process_batch`` of the stack through the fused pipeline, host clock,
   median of R calls, ms an image; and the host's NumPy bake of the same
   stack (``stack_planar_padded``), ms an image.
4. With ``--variants NAME,...`` (names of ``VARIANTS``; '' skips): copies
   of ``csrc/layout.cu`` with other tuning constants (``kBakeThreads``,
   ``kTileWords``) or cache hints, each built into a library of its own
   under ``build/bake_lab/`` (``window_lab.build_variants``), each held
   byte-equal to the host's bake and timed as in 1; beside them, as the
   yardstick of what the card reaches on the same traffic, a device-to-
   device ``Tensor.copy_`` of the planar stack's bytes.

Prints one line per reading, the ``nvidia-smi`` name and power limit, and
last one JSON object with every number. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", ".."))

import chip_smoke  # noqa: E402
from dip_benchmark_tpu_torch.models import batch  # noqa: E402
from dip_benchmark_tpu_torch.ops.layout import (  # noqa: E402
    bake_stack, bake_stack_plain)
from dip_benchmark_tpu_torch.utils.image import (  # noqa: E402
    make_layout, stack_planar_padded)

BATCH, HEIGHT, WIDTH = 8, 2336, 3504
HBM_BYTES_PER_S = 3.35e12
OUT = os.path.join(HERE, "..", "..", "build", "bake_lab")
_LOAD = "*reinterpret_cast<const uint4*>(gs + lo)"
_STORE = "column[(y + pad) * row_words] = word;"
VARIANTS = {
    "default": {},
    "t512": {"kBakeThreads": 512},
    "tile128": {"kTileWords": 128},
    "ldcs": {"edits": [(_LOAD, "__ldcs(reinterpret_cast<const uint4*>("
                               "gs + lo))")]},
    "stcs": {"edits": [(_STORE, "__stcs(column + (y + pad) * row_words, "
                                "word);")]},
    "v1": {"kVecsPerThread": 1},
    "v2": {"kVecsPerThread": 2},
    "t128": {"kBakeThreads": 128},
}


def upload_numpy(images: np.ndarray, device) -> torch.Tensor:
    staging = torch.empty(images.shape, dtype=torch.uint8, pin_memory=True)
    raw = torch.empty(images.shape, dtype=torch.uint8, device=device)
    host = staging.numpy()
    for i, image in enumerate(images):
        host[i] = image
        raw[i].copy_(staging[i], non_blocking=True)
    return raw


def upload_torch(images: np.ndarray, device) -> torch.Tensor:
    staging = torch.empty(images.shape, dtype=torch.uint8, pin_memory=True)
    raw = torch.empty(images.shape, dtype=torch.uint8, device=device)
    for i, image in enumerate(images):
        staging[i].copy_(torch.from_numpy(image))
        raw[i].copy_(staging[i], non_blocking=True)
    return raw


def upload_pageable(images: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(images).to(device)


def upload_whole(images: np.ndarray, device) -> torch.Tensor:
    staging = torch.empty(images.shape, dtype=torch.uint8, pin_memory=True)
    staging.copy_(torch.from_numpy(images))
    return staging.to(device, non_blocking=True)


def host_ms(fn, repeats: int) -> list[float]:
    """Host-clock ms of each of ``repeats`` calls of ``fn``, each ended by
    a synchronize."""
    out = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def variants(names, images, layout, host, bound_us) -> dict:
    """Each variant's device µs and share of the bound, and the copy's."""
    import ctypes

    from window_lab import build_variants
    built = build_variants(names, VARIANTS, "layout.cu", OUT)
    raw = torch.from_numpy(images).cuda()
    out = {}
    for name in names:
        lib = ctypes.CDLL(built[name][0])
        fn = lib.dip_bake_u8
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def bake(stack, fn=fn):
            planar = torch.empty((len(stack),) + layout.shape,
                                 dtype=torch.uint8, device=stack.device)
            status = fn(stack.data_ptr(), planar.data_ptr(), len(stack),
                        layout.height, layout.width, layout.pad, layout.pitch,
                        torch.cuda.current_stream().cuda_stream)
            chip_smoke.check(status == 0, f"bake variant: cudaError {status}")
            return planar

        chip_smoke.check(torch.equal(bake(raw).cpu(), host),
                         f"bake variant {name} differs from the host's bake")
        us = 1e3 * chip_smoke.timed([bake], raw)[0]
        out[name] = {"us": us, "bound_share_pct": 100 * bound_us / us}
        print(f"variant {name:8s}: {us:8.2f} us, {100 * bound_us / us:.1f} % "
              f"of the bound; equal to stack_planar_padded")
    planar = host.cuda()
    dst = torch.empty_like(planar)
    copy_us = 1e3 * chip_smoke.timed([lambda s: dst.copy_(s)], planar)[0]
    copy_bound = 1e6 * 2 * planar.numel() / HBM_BYTES_PER_S
    out["copy"] = {"us": copy_us, "bound_share_pct": 100 * copy_bound
                   / copy_us}
    print(f"device copy of {planar.numel():,} B: {copy_us:.2f} us, "
          f"{100 * copy_bound / copy_us:.1f} % of its bound")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--launches", type=int, default=50)
    ap.add_argument("--repeats", type=int, default=6)
    ap.add_argument("--variants", default="",
                    help=f"comma-separated names of {sorted(VARIANTS)}")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    smi = chip_smoke.nvidia_smi_line()
    print(f"device: {torch.cuda.get_device_name(device)} | {smi}")
    rng = np.random.default_rng(19)
    images = rng.integers(0, 256, (BATCH, HEIGHT, WIDTH, 3), np.uint8)
    layout = make_layout(HEIGHT, WIDTH)
    result = {"device": torch.cuda.get_device_name(device), "smi": smi}

    # 1. The kernel against its byte bound.
    t0 = time.perf_counter()
    host = stack_planar_padded(images, layout)
    host_bake_ms = 1e3 * (time.perf_counter() - t0)
    raw = torch.from_numpy(images).to(device)
    got = bake_stack(raw, layout)
    torch.cuda.synchronize()
    chip_smoke.check(torch.equal(got.cpu(), host),
                     "bake_u8 differs from stack_planar_padded")
    del got
    nbytes = images.size + BATCH * int(np.prod(layout.shape))
    bound_us = 1e6 * nbytes / HBM_BYTES_PER_S
    chip_smoke.TIMED_LAUNCHES = args.launches
    kernel_us, plain_us = (1e3 * ms for ms in chip_smoke.timed(
        [lambda s: bake_stack(s, layout),
         lambda s: bake_stack_plain(s, layout)], raw))
    print(f"bake_u8 B={BATCH} {HEIGHT}x{WIDTH}: {kernel_us:.2f} us (median "
          f"of {args.launches}) | bound {bound_us:.2f} us ({nbytes:,} B at "
          f"3.35 TB/s) | {100 * bound_us / kernel_us:.1f} % of the bound; "
          f"equal to stack_planar_padded | plain version on the card "
          f"{plain_us:.2f} us")
    result.update(kernel_us=kernel_us, bound_us=bound_us,
                  bound_share_pct=100 * bound_us / kernel_us, bytes=nbytes,
                  plain_us=plain_us)
    del raw

    # 2. The upload, four ways, in turns.
    ways = {"pinned_numpy": upload_numpy, "pinned_torch": upload_torch,
            "pageable": upload_pageable, "pinned_whole": upload_whole}
    for fn in ways.values():   # warm the pinned blocks and the allocator
        fn(images, device)
    samples = {name: [] for name in ways}
    order = list(ways) + list(ways)[::-1]
    for name in order:
        samples[name] += host_ms(lambda: ways[name](images, device),
                                 max(1, args.repeats // 2))
    upload = {}
    for name, ms in samples.items():
        med = statistics.median(ms)
        upload[name] = {"ms": med, "ms_min": min(ms), "ms_max": max(ms),
                        "gbps": images.size / med / 1e6}
        print(f"upload {name:13s}: {med:8.2f} ms a stack ({min(ms):.2f}-"
              f"{max(ms):.2f}, {len(ms)} runs), {images.size / med / 1e6:.1f}"
              f" GB/s, {med / BATCH:.3f} ms an image")
    result["upload"] = upload

    # 3. The batch tool end to end, beside the host's bake.
    batch.process_batch(images)
    e2e = statistics.median(host_ms(lambda: batch.process_batch(images),
                                    args.repeats))
    print(f"process_batch Fused-Pipeline B={BATCH}: {e2e / BATCH:.2f} ms an "
          f"image ({BATCH * 1e3 / e2e:.2f} images/s); the host's NumPy bake "
          f"{host_bake_ms / BATCH:.2f} ms an image")
    result.update(e2e_ms_per_image=e2e / BATCH,
                  host_bake_ms_per_image=host_bake_ms / BATCH)

    # 4. Build variants, beside a copy of the same traffic.
    names = [n for n in args.variants.split(",") if n]
    if names:
        result["variants"] = variants(names, images, layout, host, bound_us)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
