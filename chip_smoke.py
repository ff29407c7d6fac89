#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernel library from ``dip_benchmark_tpu_torch/ops/kernels/
csrc`` with nvcc, then, with no fallback anywhere:

1. prints the device banner and ``nvidia-smi``'s name and power limit;
2. builds the kernels and prints the build time;
3. runs each of the 13 on-device ops (the 12 of the matrix and the fused
   pipeline) through its kernel and through its plain PyTorch version on
   the card, on the 3504x2336 benchmark image and on 37x53 and 5x5 images,
   and requires the whole outputs to be equal (tolerance 0: the uint8
   model is bit-exact) and the crops to equal the oracle; then the fused
   pipeline on a stack of three different 3504x2336 images, in one launch;
4. drives the port's CLI once at full size (``--rounds 50 --verify
   --pipeline --csv``) with the launch counts zeroed, and requires exit 0,
   15 table rows, 13 image dumps, a CSV row with no pipeline column and a
   launch of every kernel;
5. drives the batch tool (``models.batch.main``, ``--backend cuda``) over
   a directory of eight 3504x2336 images and one of another shape, with
   the counts zeroed again, and requires every output to equal the
   oracle's fused pipeline and ``pipeline_u8`` to have run;
6. times each kernel against its plain version and, where one PyTorch call
   computes the same function, that call, with CUDA events, in the order
   kernel, plain, library, library, plain, kernel, behind a sleep kernel
   that keeps the card busy while the host queues the launches, so each
   event pair times device work and not the host's launch overhead; then
   the serving table of the fused pipeline at B = 1, 2, 4, 8: device µs
   per image, end-to-end ``process_batch`` ms per image, and its two host
   steps (layout bake, crop) timed alone;
7. prints ``{"kernels": [...]}``, the ``nvidia-smi`` line and, last,
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

from dip_benchmark_tpu_torch import cli, oracle, spec
from dip_benchmark_tpu_torch.models import batch
from dip_benchmark_tpu_torch.models.pipeline import (fused_pipeline,
                                                     fused_pipeline_plain)
from dip_benchmark_tpu_torch.ops import OPS, PLAIN, kernels
from dip_benchmark_tpu_torch.ops.kernels import build
from dip_benchmark_tpu_torch.utils.image import (from_planar_padded,
                                                 load_image, make_layout,
                                                 save_image,
                                                 stack_planar_padded,
                                                 to_planar_padded)
from dip_benchmark_tpu_torch.utils.testimage import resolve_image

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "build", "chip_smoke")
TIMED_LAUNCHES = 50      # per version, in two halves
SLEEP_CYCLES = 200_000_000  # ~0.1 s of GPU clock: covers the host's queueing
SERVING_BATCHES = (1, 2, 4, 8)
SERVING_REPEATS = 3      # end-to-end process_batch calls per batch size
CSRC = "dip_benchmark_tpu_torch/ops/kernels/csrc/"
# The card's peak rates (H100 SXM data sheet):
# HBM bytes per second; int8 tensor-core operations per second, for the
# multiply-adds of u8 data by small integer weights; operations per second
# outside the tensor cores, for compares, minima, shifts and logic.
HBM_BYTES_S = 3.35e12
MAC_OPS_S = 1979e12
ALU_OPS_S = 67e12

# CSV column -> (kernel, its source, file:line and name of the TPU kernel
# it replaces).
KERNELS = {
    "Copy": ("copy_u8", "point.cu", "ops/pallas/point.py:32", "_copy_dma"),
    "Inversion": ("point_u8<Invert>", "point.cu", "ops/pallas/point.py:56",
                  "_inversion_kernel"),
    "Grayscale": ("grayscale_u8", "point.cu", "ops/pallas/point.py:110",
                  "_grayscale_kernel"),
    "Threshold": ("point_u8<Threshold>", "point.cu", "ops/pallas/point.py:72",
                  "_threshold_kernel"),
    "Erosion-3x3-Cross": ("window_u8<MinPlus>", "window.cu",
                          "ops/pallas/window.py:313",
                          "body_plus of _make_morphology"),
    "Erosion-3x3-Square": ("window_u8<MinRect>", "window.cu",
                           "ops/pallas/window.py:297",
                           "body_rect of _make_morphology"),
    "Erosion-1x3+3x1-Square": ("window_u8<MinSep>", "window.cu",
                               "ops/pallas/window.py:363",
                               "make_erosion_separated_fused"),
    "Convolution-3x3": ("window_u8<ConvDense<3,3>>", "window.cu",
                        "ops/pallas/window.py:491", "make_convolution"),
    "Convolution-1x3+3x1": ("window_u8<ConvSep<3>>", "window.cu",
                            "ops/pallas/window.py:606",
                            "make_convolution_separated_fused"),
    "Convolution-5x5": ("window_u8<ConvDense<5,5>>", "window.cu",
                        "ops/pallas/window.py:491", "make_convolution"),
    "Convolution-1x5+5x1": ("window_u8<ConvSep<5>>", "window.cu",
                            "ops/pallas/window.py:606",
                            "make_convolution_separated_fused"),
    "Gaussian-Blur-3x3": ("window_u8<Blur3x3>", "window.cu",
                          "ops/pallas/window.py:675",
                          "make_gaussian_blur_3x3"),
    "Fused-Pipeline": ("pipeline_u8", "pipeline.cu", "models/pipeline.py:30",
                       "make_fused_pipeline_pallas"),
}

# The one PyTorch call that computes an op's whole-buffer function, where
# there is one: the yardstick, timed here and used nowhere in the port.
# None elsewhere: a threshold or luma is several calls, F.conv2d does not
# round and clamp to u8 (nor run on uint8), PyTorch has no uint8 min-pool,
# and no call writes the kernels' zero ring.
LIBRARY = {
    "Copy": torch.clone,
    "Inversion": torch.bitwise_not,
}

# Operations per position of the (Hp, pitch) plane, all three channels
# together: (multiply-adds, other operations). They set the operation
# bound beside the byte bound.
WORK = {
    "Copy": (0, 0),
    "Inversion": (0, 3),
    "Grayscale": (3, 1),
    "Threshold": (0, 3),
    "Erosion-3x3-Cross": (0, 12),
    "Erosion-3x3-Square": (0, 24),
    "Erosion-1x3+3x1-Square": (0, 12),
    "Convolution-3x3": (27, 9),
    "Convolution-1x3+3x1": (18, 18),
    "Convolution-5x5": (75, 9),
    "Convolution-1x5+5x1": (30, 18),
    "Gaussian-Blur-3x3": (27, 6),
    # luma 3 + blur 9 multiply-adds; shift, compare, 8 ANDs, round 2
    "Fused-Pipeline": (12, 12),
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


def bound(col: str, planar: torch.Tensor) -> tuple[float, str]:
    """(least ms, what bounds it) for one call of op ``col`` on
    ``planar``: each input byte read once and each output byte written
    once at the HBM rate, against its operations at the peak rates."""
    positions = planar.numel() // planar.shape[-3]
    mac, alu = WORK[col]
    times = {"bytes": 2 * planar.numel() / HBM_BYTES_S,
             "operations": max(2 * mac * positions / MAC_OPS_S,
                               alu * positions / ALU_OPS_S)}
    by = max(times, key=times.get)
    return 1e3 * times[by], by


def compare_with_plain(sizes) -> dict:
    """Kernel against plain version (whole buffer) and oracle (crop) for
    every op and image; returns the largest |kernel - plain| per op."""
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
                                 oracle.IMAGE_OPS[col](img)),
                  f"{col} on {label}: kernel differs from the oracle")
        print(f"  {label}: {len(OPS)} ops bit-equal to plain version and "
              f"oracle")
    return errs


def compare_batched(images, label) -> int:
    """The pipeline kernel on a (B, 3, Hp, pitch) stack, one launch,
    against its plain version and the oracle of each image."""
    layout = make_layout(*images[0].shape[:2])
    stack = stack_planar_padded(images, layout).cuda()
    got, plain = fused_pipeline(stack), fused_pipeline_plain(stack)
    torch.cuda.synchronize()
    err = int((got.int() - plain.int()).abs().max())
    check(torch.equal(got, plain),
          f"batched pipeline on {label}: kernel differs from its plain "
          f"version (max |delta| {err})")
    crops = from_planar_padded(got, layout)
    for i, img in enumerate(images):
        check(np.array_equal(crops[i], oracle.fused_pipeline(img)),
              f"batched pipeline on {label}, image {i}: kernel differs "
              f"from the oracle")
    print(f"  {label}: batched pipeline bit-equal to plain version and "
          f"oracle")
    return err


def drive_main_path(img, label) -> dict:
    """Run the port's CLI once at full size with the pipeline row; return
    that run's launch counts."""
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
                       "--pipeline", "--csv", csv])
    counts = dict(kernels.LAUNCHES)
    text = buf.getvalue()
    print(text, end="")
    check(rc == 0, f"cli.main exited {rc}")
    rows = [ln for ln in text.splitlines() if ln.startswith("| ")]
    check(len(rows) == 15, f"expected 15 table rows, got {len(rows)}")
    prefixes = [p for _, p, _ in spec.OPERATION_MATRIX if p] + ["pipeline"]
    names = [f"{p}-benchmark-image.png" for p in prefixes]
    missing = [n for n in names if not os.path.exists(os.path.join(dumps, n))]
    check(len(names) == 13 and not missing, f"missing dumps {missing}")
    with open(csv) as f:
        lines = f.read().splitlines()
    check(lines[0] == spec.CSV_HEADER and len(lines) == 2
          and lines[1].startswith("H100-cuda,")
          and len(lines[1].split(",")) == len(spec.CSV_COLUMNS) + 1,
          f"bad CSV {lines}")
    unused = [k for k, *_ in KERNELS.values() if counts.get(k, 0) < 1]
    check(not unused, f"kernels not launched on the main path: {unused}")
    print(f"  main path ({label}): rc 0, 15 rows, 13 dumps, --verify "
          f"passed; launches {counts}")
    return counts


def drive_batch_tool(images, other) -> dict:
    """Run the batch tool over a directory of ``images`` (one shape) and
    ``other`` (another shape); return that run's launch counts."""
    indir = os.path.join(OUT, "batch_in")
    outdir = os.path.join(OUT, "batch_out")
    for d in (indir, outdir):
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(indir)
    named = {f"img{i}.png": img for i, img in enumerate(images)}
    named["other.png"] = other
    for name, img in named.items():
        save_image(os.path.join(indir, name), img)
    kernels.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        rc = batch.main([indir, outdir, "--batch-size", "8",
                         "--backend", "cuda"])
    seconds = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    check(rc == 0, f"models.batch.main exited {rc}")
    check(sorted(os.listdir(outdir)) == sorted(named),
          f"batch outputs {sorted(os.listdir(outdir))}")
    for name, img in named.items():
        check(np.array_equal(load_image(os.path.join(outdir, name)),
                             oracle.fused_pipeline(img)),
              f"batch tool: {name} differs from the oracle")
    check(counts.get("pipeline_u8", 0) >= 2,
          f"batch tool launched pipeline_u8 {counts.get('pipeline_u8')} "
          f"times, want one per shape group")
    print(f"  batch tool: rc 0, {len(named)} images in {seconds:.2f} s "
          f"(PNG decode and encode included), every output equal to the "
          f"oracle; launches {counts} | {buf.getvalue().strip()}")
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


def timed(versions, planar) -> list[float]:
    """Median ms of each version over TIMED_LAUNCHES, in two halves run
    in the order v0, v1, ..., vn, vn, ..., v1, v0."""
    half = TIMED_LAUNCHES // 2
    samples = [[] for _ in versions]
    order = list(range(len(versions)))
    for i in order + order[::-1]:
        samples[i] += device_ms(versions[i], planar, half)
    return [statistics.median(s) for s in samples]


def host_ms(fn) -> float:
    """Median host-clock ms of SERVING_REPEATS calls of ``fn``."""
    samples = []
    for _ in range(SERVING_REPEATS):
        t0 = time.perf_counter()
        fn()
        samples.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(samples)


def serving_table(images) -> list[dict]:
    """The fused pipeline at each batch size: device time per image of
    one launch on the stack, end-to-end ``process_batch`` time per image
    (host layout bake, copy in, kernel, copy out, crop), and the two host
    steps of it timed alone: the layout bake into pinned memory and the
    crop of a pinned result to (B, H, W, 3)."""
    images = np.stack(images)
    layout = make_layout(*images.shape[1:3])
    rows = []
    for b in SERVING_BATCHES:
        stack = stack_planar_padded(images[:b], layout).cuda()
        dev_ms = timed([fused_pipeline], stack)[0]
        batch.process_batch(images[:b])  # warm the pinned-memory cache
        e2e = host_ms(lambda: batch.process_batch(images[:b]))
        bake = host_ms(lambda: stack_planar_padded(images[:b], layout,
                                                   pin_memory=True))
        pinned = stack.cpu().pin_memory()
        crop = host_ms(lambda: from_planar_padded(pinned, layout))
        bound_ms, _ = bound("Fused-Pipeline", stack)
        rows.append({"batch": b, "device_us_per_image": 1e3 * dev_ms / b,
                     "bound_us_per_image": 1e3 * bound_ms / b,
                     "e2e_ms_per_image": e2e / b,
                     "bake_ms_per_image": bake / b,
                     "crop_ms_per_image": crop / b})
    return rows


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
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
            print("   ", ln.strip())

    img, label = resolve_image()
    rng = np.random.default_rng(0)
    sizes = [(label, img),
             ("random 37x53", rng.integers(0, 256, (37, 53, 3), np.uint8)),
             ("random 5x5", rng.integers(0, 256, (5, 5, 3), np.uint8))]
    # Eight different full-size images: the benchmark image shifted
    # sideways, its mirror, and random noise.
    h, w = img.shape[:2]
    variants = [np.ascontiguousarray(np.roll(img, 257 * i, axis=1))
                for i in range(6)]
    variants += [np.ascontiguousarray(img[::-1]),
                 rng.integers(0, 256, img.shape, np.uint8)]
    print("[3] kernel against plain version, tolerance 0")
    errs = compare_with_plain(sizes)
    errs["Fused-Pipeline"] = max(
        errs["Fused-Pipeline"],
        compare_batched(variants[5:], f"B=3 {label} variants"))

    print("[4] main path: dip_benchmark_tpu_torch.cli.main --pipeline")
    counts = drive_main_path(img, label)

    print("[5] batch tool: dip_benchmark_tpu_torch.models.batch.main")
    other = np.ascontiguousarray(img[: h // 2, : w // 3])
    batch_counts = drive_batch_tool(variants, other)

    print(f"[6] device time, median of {TIMED_LAUNCHES} launches each, CUDA "
          f"events, {label} | {smi}")
    planar = to_planar_padded(img, make_layout(h, w)).cuda()
    entries = []
    for col, (name, src, where, tpu_name) in KERNELS.items():
        versions = [OPS[col], PLAIN[col]]
        if col in LIBRARY:
            versions.append(LIBRARY[col])
        ms, plain_ms, *lib = timed(versions, planar)
        library_ms = lib[0] if lib else None
        bound_ms, bound_by = bound(col, planar)
        lib_txt = "none" if library_ms is None else f"{library_ms:9.4f} ms"
        print(f"    {col:24s} {name:28s} kernel {ms:9.4f} ms | plain "
              f"{plain_ms:9.4f} ms | library {lib_txt} | bound "
              f"{bound_ms:.4f} ms ({bound_by})")
        entries.append({
            "name": name, "op": col, "route": "cuda", "source": CSRC + src,
            "replaces": "dip_benchmark_tpu/" + where, "tpu_kernel": tpu_name,
            "launches": counts.get(name, 0), "max_abs_err": errs[col], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms})
    print(f"    serving: fused pipeline on {label} stacks | {smi}")
    serving = serving_table(variants)
    for row in serving:
        print(f"    B={row['batch']}: device {row['device_us_per_image']:8.2f}"
              f" us/image (bound {row['bound_us_per_image']:.2f}) | "
              f"process_batch end to end {row['e2e_ms_per_image']:8.2f} "
              f"ms/image (host bake {row['bake_ms_per_image']:.2f}, "
              f"crop {row['crop_ms_per_image']:.2f})")

    summary = {"kernels": entries}
    with open(os.path.join(OUT, "summary.json"), "w") as f:
        json.dump({**summary, "serving": serving, "batch_tool_launches":
                   batch_counts, "nvidia_smi": smi, "image": label}, f,
                  indent=1)
    print(json.dumps(summary))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
