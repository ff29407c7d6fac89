#!/usr/bin/env python3
"""What a launch of ``pipeline_u8`` and of ``chain_u8`` C2 costs besides its
pixels, timed on one GPU.

    python3 benchmarks/h100/launch_scaling.py [--launches N]

Both kernels compute the same function (luma, threshold, 3x3 square
erosion, 1-2-1 blur, to all three planes). For each, at the image areas
``SHAPES`` (crops of the 3504x2336 benchmark image) and at
``BATCHES`` images a launch, the median device time of N launches from
CUDA events behind a sleep kernel (``chip_smoke.timed``, L2-warm), through
the port's own wrappers (``fused_pipeline``, ``make_fused_chain``). Then:

- each kernel's resident blocks an SM as it launches for one image
  (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, from a copy of its
  source built with a small probe appended, ``window_lab.build_variants``),
  its grid at every shape, and how many waves of the card that grid is;
- the device time at heights whose grids are one wave and two waves of
  the card at the benchmark width (B = 1);
- a least-squares fit, over every (shape, B) point, of time = fixed +
  slope * pixels: the fixed µs a launch and the µs a megapixel.

Prints one line per reading, the fits, the ``nvidia-smi`` name and power
limit, and last one JSON object with every number. Needs a CUDA device and
nvcc; exits 1 without a device.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.join(HERE, "..", "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402
from dip_benchmark_tpu_torch.models import chain  # noqa: E402
from dip_benchmark_tpu_torch.models.pipeline import fused_pipeline  # noqa: E402
from dip_benchmark_tpu_torch.utils.image import (  # noqa: E402
    make_layout, stack_planar_padded)
from dip_benchmark_tpu_torch.utils.testimage import resolve_image  # noqa: E402
from window_lab import build_variants, source, tuning  # noqa: E402

OUT = os.path.join(ROOT, "build", "launch_scaling")
SHAPES = ((1168, 1168), (2336, 1752), (2336, 3504))  # (height, width)
BATCHES = (1, 8)
C2 = chip_smoke.CHAINS["C2"]
# Appended to each kernel's source: its resident blocks an SM and threads a
# block, for the launch the library makes (chain_u8 with C2's radius 2).
PROBES = {
    "pipeline": ("pipeline.cu", r"""
DIP_API int lab_occupancy(int* blocks, int* threads) {
  *threads = kBlock;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, PIPELINE_ONE, kBlock, 0));
}
"""),
    "chain": ("chain.cu", r"""
DIP_API int lab_occupancy(int* blocks, int* threads) {
  const size_t smem = 2 * static_cast<size_t>(kTileRows + 4) * kStride * 4;
  *threads = kU8Block;
  if (const int e = allow_smem(chain_u8<true>, smem)) return e;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, chain_u8<true>, kU8Block, smem));
}
"""),
}


def occupancy(lib: str) -> tuple[int, int]:
    import ctypes
    fn = ctypes.CDLL(lib).lab_occupancy
    blocks, threads = ctypes.c_int(), ctypes.c_int()
    rc = fn(ctypes.byref(blocks), ctypes.byref(threads))
    if rc:
        raise RuntimeError(f"occupancy query: cudaError {rc}")
    return blocks.value, threads.value


def grid_blocks(kind: str, hp: int, pitch: int, batch: int) -> int:
    """Blocks of the launch the library makes for one (Hp, pitch) stack."""
    if kind == "pipeline":
        text = source("pipeline.cu")
        if "constexpr int kTileH" in text:  # the shared-memory tile: 128 x 32 bytes
            t = tuning(text, ("kTileW", "kTileH"))
            rows = t["kTileH"]
        else:  # the strip walk: kPipeWarps strips of kPipeRows rows
            t = tuning(text, ("kTileW", "kPipeRows", "kPipeWarps"))
            rows = t["kPipeRows"] * t["kPipeWarps"]
        return math.ceil(pitch / t["kTileW"]) * math.ceil(hp / rows) * batch
    t = tuning(source("chain.cu"), ("kTileWords", "kTileRows", "kHaloWords"))
    per_tile = t["kTileWords"] - 2 * t["kHaloWords"]
    return (math.ceil(pitch // 4 / per_tile) * math.ceil(hp / t["kTileRows"])
            * batch)


def wave_height(kind: str, width: int, blocks: int) -> int:
    """The largest image height whose B = 1 grid is at most ``blocks``."""
    lo, hi = 3, 20000
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lay = make_layout(mid, width)
        if grid_blocks(kind, lay.padded_height, lay.pitch, 1) <= blocks:
            lo = mid
        else:
            hi = mid - 1
    return lo


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--launches", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("launch_scaling: no CUDA device", file=sys.stderr)
        return 1
    chip_smoke.TIMED_LAUNCHES = args.launches
    smi = chip_smoke.nvidia_smi_line()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    occ = {}
    for kind, (src, probe) in PROBES.items():
        # The strip walk's B = 1 launch is pipeline_u8<kPipeAheadOne>; the
        # shared-memory tile kernel is not a template.
        one = ("pipeline_u8" if "constexpr int kTileH" in source(src)
               else "pipeline_u8<kPipeAheadOne>")
        lib, _ = build_variants(["probe"], {"probe": {}}, src,
                                os.path.join(OUT, kind),
                                probe.replace("PIPELINE_ONE", one))["probe"]
        blocks, threads = occupancy(lib)
        occ[kind] = {"blocks_per_sm": blocks, "threads": threads,
                     "wave_blocks": blocks * sms}
    img, label = resolve_image()
    width = img.shape[1]
    shapes = list(SHAPES)
    waves = {}
    for kind in occ:
        for n in (1, 2):
            h = wave_height(kind, width, n * occ[kind]["wave_blocks"])
            waves[(kind, n)] = h
            shapes.append((h, width))
    kernels = {
        "pipeline": lambda lay, b: fused_pipeline,
        "chain": lambda lay, b: chain.make_fused_chain(
            lay, C2, batch=b if b > 1 else 0),
    }
    readings = []
    print(f"{label} crops | {smi} | median of {args.launches} launches, "
          f"L2-warm | blocks an SM {json.dumps(occ)}")
    for h, w in sorted(set(shapes)):
        # A height beyond the image's continues with its mirror.
        tall = np.concatenate([img, img[::-1]] * math.ceil(h / (
            2 * img.shape[0])))
        crop = np.ascontiguousarray(tall[:h, :w])
        for b in BATCHES:
            for kind, make in kernels.items():
                is_wave = [n for (k, n), hh in waves.items()
                           if k == kind and hh == h and w == width]
                if (h, w) not in SHAPES and (b != 1 or not is_wave):
                    continue
                pad = 2
                lay = make_layout(h, w, pad=pad)
                stack = stack_planar_padded(np.stack([crop] * b), lay).cuda()
                fn = make(lay, b)
                planar = stack if b > 1 or kind == "pipeline" else stack[0]
                if kind == "chain":
                    fn.prepare(planar.device)
                us = 1e3 * chip_smoke.timed([fn], planar)[0]
                blocks = grid_blocks(kind, lay.padded_height, lay.pitch, b)
                row = {"kernel": kind, "height": h, "width": w, "batch": b,
                       "megapixels": b * h * w / 1e6, "us": us,
                       "us_per_image": us / b, "grid_blocks": blocks,
                       "waves": blocks / occ[kind]["wave_blocks"],
                       "one_wave_shape": bool(is_wave)}
                readings.append(row)
                print(f"  {kind:8s} {h:5d}x{w:<5d} B={b} {us:9.2f} us "
                      f"({us / b:8.2f} an image) | {blocks:6d} blocks, "
                      f"{row['waves']:6.2f} waves"
                      + (f" (height of {is_wave[0]} wave"
                         f"{'s' if is_wave[0] > 1 else ''})" if is_wave
                         else ""))
    fits = {}
    for kind in kernels:
        pts = [(r["megapixels"], r["us"]) for r in readings
               if r["kernel"] == kind]
        x = np.array([[1.0, p] for p, _ in pts])
        y = np.array([t for _, t in pts])
        (fixed, slope), *_ = np.linalg.lstsq(x, y, rcond=None)
        resid = y - x @ np.array([fixed, slope])
        fits[kind] = {"fixed_us": float(fixed), "us_per_megapixel":
                      float(slope), "max_abs_residual_us":
                      float(np.abs(resid).max()), "points": len(pts)}
        print(f"  fit {kind:8s}: {fixed:7.2f} us fixed + {slope:7.3f} us a "
              f"megapixel (largest residual {np.abs(resid).max():.2f} us, "
              f"{len(pts)} points)")
    print(smi)
    print(json.dumps({"image": label, "nvidia_smi": smi, "sms": sms,
                      "occupancy": occ, "readings": readings,
                      "fits": fits}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
