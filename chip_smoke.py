#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernel library from ``dip_benchmark_tpu_torch/ops/kernels/
csrc`` with nvcc, then, with no fallback anywhere:

1. prints the device banner and ``nvidia-smi``'s name and power limit;
2. builds the kernels and prints the build time;
3. runs each of the 12 on-device ops through its kernel and through its
   plain PyTorch version on the card, on the 3504x2336 benchmark image and
   on 37x53 and 5x5 images, and requires the whole outputs to be equal
   (tolerance 0: the uint8 model is bit-exact) and the crops to equal the
   oracle;
4. drives the port's CLI once at full size (``--rounds 50 --verify
   --csv``) with the launch counts zeroed, and requires exit 0, 14 table
   rows, 12 image dumps, a CSV row and a launch of every kernel;
5. times each kernel against its plain version with CUDA events, in the
   order kernel, plain, plain, kernel, behind a sleep kernel that keeps the
   card busy while the host queues the launches, so each event pair times
   device work and not the host's launch overhead;
6. prints ``{"kernels": [...]}``, the ``nvidia-smi`` line and, last,
   ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero, and without a CUDA device the
script exits 1 before printing any result. The images, the CSV, the build
log and a summary go to ``build/chip_smoke/`` in the checkout.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from dip_benchmark_tpu_torch import cli, spec
from dip_benchmark_tpu_torch.ops import OPS, PLAIN, kernels
from dip_benchmark_tpu_torch.ops.kernels import build
from dip_benchmark_tpu_torch.session import BenchmarkSession
from dip_benchmark_tpu_torch.utils.image import (from_planar_padded,
                                                 make_layout, save_image,
                                                 to_planar_padded)
from dip_benchmark_tpu_torch.utils.testimage import resolve_image

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "build", "chip_smoke")
TIMED_LAUNCHES = 50      # per version, in two halves
SLEEP_CYCLES = 200_000_000  # ~0.1 s of GPU clock: covers the host's queueing
CSRC = "dip_benchmark_tpu_torch/ops/kernels/csrc/"
PALLAS = "dip_benchmark_tpu/ops/pallas/"

# CSV column -> (kernel, its source, file:line and name of the TPU kernel
# it replaces).
KERNELS = {
    "Copy": ("copy_u8", "point.cu", "point.py:32", "_copy_dma"),
    "Inversion": ("point_u8<Invert>", "point.cu", "point.py:56",
                  "_inversion_kernel"),
    "Grayscale": ("grayscale_u8", "point.cu", "point.py:110",
                  "_grayscale_kernel"),
    "Threshold": ("point_u8<Threshold>", "point.cu", "point.py:72",
                  "_threshold_kernel"),
    "Erosion-3x3-Cross": ("window_u8<MinPlus>", "window.cu", "window.py:313",
                          "body_plus of _make_morphology"),
    "Erosion-3x3-Square": ("window_u8<MinRect>", "window.cu", "window.py:297",
                           "body_rect of _make_morphology"),
    "Erosion-1x3+3x1-Square": ("window_u8<MinSep>", "window.cu",
                               "window.py:363",
                               "make_erosion_separated_fused"),
    "Convolution-3x3": ("window_u8<ConvDense<3,3>>", "window.cu",
                        "window.py:491", "make_convolution"),
    "Convolution-1x3+3x1": ("window_u8<ConvSep<3>>", "window.cu",
                            "window.py:606",
                            "make_convolution_separated_fused"),
    "Convolution-5x5": ("window_u8<ConvDense<5,5>>", "window.cu",
                        "window.py:491", "make_convolution"),
    "Convolution-1x5+5x1": ("window_u8<ConvSep<5>>", "window.cu",
                            "window.py:606",
                            "make_convolution_separated_fused"),
    "Gaussian-Blur-3x3": ("window_u8<Blur3x3>", "window.cu", "window.py:675",
                          "make_gaussian_blur_3x3"),
}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def compare_with_plain(sizes) -> dict:
    """Kernel against plain version (whole buffer) and oracle (crop) for
    every op and image; returns the largest |kernel - plain| per op."""
    golden = BenchmarkSession.oracle_ops()
    errs = {col: 0 for col in OPS}
    for label, img in sizes:
        layout = make_layout(*img.shape[:2])
        planar = to_planar_padded(img, layout).cuda()
        for col, fn in OPS.items():
            got, plain = fn(planar), PLAIN[col](planar)
            torch.cuda.synchronize()
            err = int((got.int() - plain.int()).abs().max())
            errs[col] = max(errs[col], err)
            check(torch.equal(got, plain),
                  f"{col} on {label}: kernel differs from its plain version "
                  f"(max |delta| {err})")
            check(np.array_equal(from_planar_padded(got, layout),
                                 golden[col](img)),
                  f"{col} on {label}: kernel differs from the oracle")
        print(f"  {label}: 12 ops bit-equal to plain version and oracle")
    return errs


def drive_main_path(img, label) -> dict:
    """Run the port's CLI once at full size; return that run's launch
    counts."""
    path = os.path.join(OUT, "benchmark-image.png")
    save_image(path, img)
    dumps = os.path.join(OUT, "dumps")
    shutil.rmtree(dumps, ignore_errors=True)
    csv = os.path.join(OUT, "results.csv")
    if os.path.exists(csv):
        os.unlink(csv)
    buf = io.StringIO()
    kernels.reset_launches()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([path, dumps, "--rounds", "50", "--verify",
                       "--csv", csv])
    counts = dict(kernels.LAUNCHES)
    text = buf.getvalue()
    print(text, end="")
    check(rc == 0, f"cli.main exited {rc}")
    rows = [ln for ln in text.splitlines() if ln.startswith("| ")]
    check(len(rows) == 14, f"expected 14 table rows, got {len(rows)}")
    names = [f"{p}-benchmark-image.png" for _, p, _ in spec.OPERATION_MATRIX
             if p]
    missing = [n for n in names if not os.path.exists(os.path.join(dumps, n))]
    check(len(names) == 12 and not missing, f"missing dumps {missing}")
    with open(csv) as f:
        lines = f.read().splitlines()
    check(lines[0] == spec.CSV_HEADER and len(lines) == 2
          and lines[1].startswith("H100-cuda,"), f"bad CSV {lines}")
    unused = [k for k, *_ in KERNELS.values() if counts.get(k, 0) < 1]
    check(not unused, f"kernels not launched on the main path: {unused}")
    print(f"  main path ({label}): rc 0, 14 rows, 12 dumps, --verify "
          f"passed; launches {counts}")
    return counts


def device_ms(fn, planar, n: int) -> list[float]:
    """Device time of each of ``n`` launches of ``fn`` from CUDA events.
    A sleep kernel queued first keeps the card busy until the host has
    queued every launch, so no event pair spans host-side work."""
    fn(planar)
    torch.cuda.synchronize()
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for start, end in marks:
        start.record()
        fn(planar)
        end.record()
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in marks]


def kernel_and_plain_ms(kernel, plain, planar) -> tuple[float, float]:
    """Medians over TIMED_LAUNCHES each, run kernel, plain, plain, kernel."""
    half = TIMED_LAUNCHES // 2
    k = device_ms(kernel, planar, half)
    p = device_ms(plain, planar, half)
    p += device_ms(plain, planar, half)
    k += device_ms(kernel, planar, half)
    return statistics.median(k), statistics.median(p)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    os.makedirs(OUT, exist_ok=True)
    props = torch.cuda.get_device_properties(0)
    smi = nvidia_smi_line()
    print(f"[1] device: {torch.cuda.get_device_name(0)} | capability "
          f"{props.major}.{props.minor} | SMs {props.multi_processor_count} "
          f"| nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    kernels.load()
    print(f"[2] built {build.library_path()} in "
          f"{time.perf_counter() - t0:.1f} s")
    with open(os.path.join(OUT, "build.log"), "w") as f:
        f.write(build.build_log)
    for ln in build.build_log.splitlines():
        if "registers" in ln or "spill" in ln:
            print("   ", ln.strip())

    img, label = resolve_image()
    rng = np.random.default_rng(0)
    sizes = [(label, img),
             ("random 37x53", rng.integers(0, 256, (37, 53, 3), np.uint8)),
             ("random 5x5", rng.integers(0, 256, (5, 5, 3), np.uint8))]
    print("[3] kernel against plain version, tolerance 0")
    errs = compare_with_plain(sizes)

    print("[4] main path: dip_benchmark_tpu_torch.cli.main")
    counts = drive_main_path(img, label)

    print(f"[5] device time, median of {TIMED_LAUNCHES} launches each, CUDA "
          f"events, {label} | {smi}")
    planar = to_planar_padded(img, make_layout(*img.shape[:2])).cuda()
    entries = []
    for col, (name, src, where, tpu_name) in KERNELS.items():
        ms, plain_ms = kernel_and_plain_ms(OPS[col], PLAIN[col], planar)
        print(f"    {col:24s} {name:28s} kernel {ms:9.4f} ms | plain "
              f"{plain_ms:9.4f} ms")
        entries.append({
            "name": name, "op": col, "route": "cuda", "source": CSRC + src,
            "replaces": PALLAS + where, "tpu_kernel": tpu_name,
            "launches": counts[name],
            "max_abs_err": errs[col], "ms": ms, "plain_ms": plain_ms})

    summary = {"kernels": entries}
    with open(os.path.join(OUT, "summary.json"), "w") as f:
        json.dump({**summary, "nvidia_smi": smi, "image": label}, f, indent=1)
    print(json.dumps(summary))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
