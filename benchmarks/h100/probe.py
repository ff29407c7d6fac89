#!/usr/bin/env python3
"""Device-time probes of the port's kernels on one GPU.

    python3 benchmarks/h100/probe.py [--launches N] [--flush-mb M] \
        [--dtype uint8|float32]

On the 3504x2336 benchmark image, for each op of the matrix, the fused
pipeline and ``chip_smoke.py``'s fused chains C1-C4 (each on a planar
baked with its halo) in the chosen data model (default uint8):

- ``profiler_us``: ``torch.profiler``'s mean device time of the op's CUDA
  kernel over N launches;
- ``warm_us``: median CUDA-event time of N launches of the kernel on the
  same input, which stays partly in L2 between launches;
- ``cold_us``: the same with L2 evicted before each launch by writing an
  M MB buffer;

and once, ``empty_us``, the median time of an event pair with nothing
between. Every event series is queued behind a sleep kernel so no event
pair spans the host's launch path. Prints one line per op, the
``nvidia-smi`` name and power limit, and last one JSON object with every
number. Needs a CUDA device; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from chip_smoke import CHAINS  # noqa: E402
from dip_benchmark_tpu_torch.models import chain  # noqa: E402
from dip_benchmark_tpu_torch.ops import OPS, OPS_F32  # noqa: E402
from dip_benchmark_tpu_torch.utils.image import (  # noqa: E402
    make_layout, to_planar_padded, to_planar_padded_f32)
from dip_benchmark_tpu_torch.utils.testimage import resolve_image  # noqa: E402

SLEEP_CYCLES = 200_000_000  # ~0.1 s of GPU clock: covers the host's queueing
KERNEL_NAMES = ("copy_u8", "point_u8", "grayscale_u8", "window_u8",
                "pipeline_u8", "point_f32", "grayscale_f32", "window_f32",
                "pipeline_f32", "chain_u8", "chain_f32", "window_taps")
# data model -> (its ops, its layout bake)
MODELS = {"uint8": (OPS, to_planar_padded),
          "float32": (OPS_F32, to_planar_padded_f32)}


def event_us(fn, n: int, flush: torch.Tensor | None = None) -> float:
    """Median device time of ``fn()`` over ``n`` event pairs, in µs."""
    fn()
    torch.cuda.synchronize()
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for start, end in marks:
        if flush is not None:
            flush.fill_(1)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return 1e3 * statistics.median(s.elapsed_time(e) for s, e in marks)


def profiler_us(fn, n: int) -> float | None:
    """Mean device time of the port's kernel in ``n`` calls of ``fn``, from
    ``torch.profiler``; None if the trace holds no device time for it."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    for avg in prof.key_averages():
        if any(k in avg.key for k in KERNEL_NAMES):
            total = getattr(avg, "self_device_time_total",
                            getattr(avg, "self_cuda_time_total", 0))
            if total and avg.count:
                return total / avg.count
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--launches", type=int, default=20)
    ap.add_argument("--flush-mb", type=int, default=256)
    ap.add_argument("--dtype", choices=sorted(MODELS), default="uint8")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    img, label = resolve_image()
    ops, bake = MODELS[args.dtype]
    planar = bake(img, make_layout(*img.shape[:2])).cuda()
    flush = torch.empty(args.flush_mb << 20, dtype=torch.uint8, device="cuda")
    n = args.launches
    result = {"image": label, "dtype": args.dtype, "nvidia_smi": smi,
              "launches": n, "flush_mb": args.flush_mb,
              "empty_us": event_us(lambda: None, n), "ops": {}}
    print(f"{label} {args.dtype} | {smi} | {n} launches | empty event pair "
          f"{result['empty_us']:.2f} us")
    runs = {col: (fn, planar) for col, fn in ops.items()}
    for name, cols in CHAINS.items():
        layout = make_layout(*img.shape[:2],
                             pad=max(2, *chain.check_chain(cols)))
        make = (chain.make_fused_chain_f32 if args.dtype == "float32"
                else chain.make_fused_chain)
        runs[name] = (make(layout, cols), bake(img, layout).cuda())
    for col, (fn, x) in runs.items():
        def call(fn=fn, x=x):
            return fn(x)
        row = {"profiler_us": profiler_us(call, n),
               "warm_us": event_us(call, n),
               "cold_us": event_us(call, n, flush)}
        result["ops"][col] = row
        prof = ("not measured" if row["profiler_us"] is None
                else f"{row['profiler_us']:.2f}")
        print(f"  {col:24s} profiler {prof:>12s} us | events warm "
              f"{row['warm_us']:8.2f} us | cold {row['cold_us']:8.2f} us")
    print(smi)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
