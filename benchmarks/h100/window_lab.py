#!/usr/bin/env python3
"""Build settings of the uint8 window skeleton, timed on one GPU.

    python3 benchmarks/h100/window_lab.py [--variants NAME,...] [--sass]

Compiles ``csrc/window.cu`` once per variant of its tuning constants
(``kStripRows``, ``kPrefetchRows``, ``kFieldWords``, ``kIntWords``; a
variant is a copy of the source with other values), one ``nvcc`` process
per variant, all started together, each into a library of its own under
``build/window_lab/``. Then, on the 3504x2336 benchmark image, for every
``window_u8_strip`` body of the op matrix and the general ``ConvDense``
(on ``chip_smoke.DENSE_MASKS``), and for every variant: the output
against the body's plain version (whole buffer, tolerance 0), and the
median device time of N launches from CUDA events behind a sleep kernel,
L2-warm (the same input again) and L2-cold (a 256 MB write between
launches). With ``--sass`` it also prints, from
``cuobjdump -sass`` of each library, each kernel's static instruction count
per output byte (the strip loop is unrolled, so that is what a thread
issues), its most frequent opcodes, and how many of them are byte
min/max, permutes, multiply-adds, loads and shuffles (in the JSON).
Prints the ``nvidia-smi`` name and power limit, and last one JSON object
with every number. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
sys.path.insert(0, ROOT)

from chip_smoke import DENSE_MASKS  # noqa: E402
from dip_benchmark_tpu_torch import spec  # noqa: E402
from dip_benchmark_tpu_torch.ops import window  # noqa: E402
from dip_benchmark_tpu_torch.ops.kernels import build  # noqa: E402
from dip_benchmark_tpu_torch.utils.image import (  # noqa: E402
    make_layout, to_planar_padded)
from dip_benchmark_tpu_torch.utils.testimage import resolve_image  # noqa: E402

OUT = os.path.join(ROOT, "build", "window_lab")
SLEEP_CYCLES = 200_000_000
TUNING = ("kStripRows", "kPrefetchRows", "kFieldWords", "kIntWords")
VARIANTS = {
    "default": {},
    "rows32": {"kStripRows": 32},
    "pre8": {"kPrefetchRows": 8},
    "field1": {"kFieldWords": 1},
    "field4": {"kFieldWords": 4},
    "int2": {"kIntWords": 2},
}
# Opcode families counted in the SASS of each kernel.
FAMILIES = {"minmax": ("VIMNMX", "VMNMX", "IMNMX", "VABSDIFF4"),
            "prmt": ("PRMT",), "shf": ("SHF",), "imad": ("IMAD", "IMUL"),
            "ldg": ("LDG",), "stg": ("STG",), "shfl": ("SHFL",)}


def bodies():
    """label -> (C entry, arguments after the geometry, plain version)."""
    out = {}
    for label, mask, reduce in (
            ("MinPlus", spec.CROSS_MASK_3X3, "min"),
            ("MinRect", spec.SQUARE_MASK_3X3, "min"),
            ("MaxPlus", spec.CROSS_MASK_3X3, "max"),
            ("MaxRect", spec.SQUARE_MASK_3X3, "max")):
        taps = window.mask_to_taps(mask)
        _, entry, extra = window.morphology_launch(taps, reduce)
        f = torch.minimum if reduce == "min" else torch.maximum
        out[label] = (entry, extra, lambda p, t=taps, f=f:
                      window.morphology_plain(p, t, f))
    out["MinSep"] = ("dip_erosion_sep_u8", (), window.erosion_sep_plain)
    out["Blur3x3"] = ("dip_blur3x3_u8", (), window.blur3x3_plain)
    for mask, shift in ((spec.BLUR_3X3_INT, spec.BLUR_3X3_SHIFT),
                        (spec.BLUR_5X5_INT, spec.BLUR_5X5_SHIFT),
                        *DENSE_MASKS.values()):
        name, entry, extra = window.convolution_launch(mask, shift)
        out[name.split("<", 1)[1][:-1]] = (
            entry, extra, lambda p, m=mask, s=shift:
            window.conv_dense_plain(p, m, s))
    for n, row, col, shift in (
            (3, spec.BLUR_1X3_INT, spec.BLUR_3X1_INT, spec.BLUR_SEP3_SHIFT),
            (5, spec.BLUR_1X5_INT, spec.BLUR_5X1_INT, spec.BLUR_SEP5_SHIFT)):
        out[f"ConvSep<{n}>"] = (
            "dip_conv_sep_u8", (n, window._int_array(row),
                                window._int_array(col), shift),
            lambda p, r=row, c=col, s=shift: window.conv_sep_plain(p, r, c, s))
    return out


def source(name: str = "window.cu") -> str:
    with open(os.path.join(build.CSRC, name)) as f:
        return f.read()


def tuning(text: str, knobs=TUNING) -> dict:
    """The tuning constants' values in the source ``text``."""
    return {k: int(re.search(rf"constexpr int {k} = (-?\d+);", text)[1])
            for k in knobs}


def build_variants(names, variants=None, src_name: str = "window.cu",
                   out: str = OUT, append: str = "") -> dict:
    """variant -> (library path, ptxas output): ``src_name`` from csrc/,
    with the code ``append`` after it, with each variant's constants
    (``variants``, default ``VARIANTS``) substituted, each into a library
    of its own under ``out``; all compiled at once."""
    variants = VARIANTS if variants is None else variants
    os.makedirs(out, exist_ok=True)
    nvcc = build.nvcc_path()
    text = source(src_name) + append
    stem = src_name.rsplit(".", 1)[0]
    procs = {}
    for name in names:
        src = os.path.join(out, f"{stem}_{name}.cu")
        lib = os.path.join(out, f"{stem}_{name}.so")
        variant = text
        for k, v in variants[name].items():
            variant = re.sub(rf"constexpr int {k} = -?\d+;",
                             f"constexpr int {k} = {v};", variant)
        with open(src, "w") as f:
            f.write(variant)
        cmd = [nvcc, *build.NVCC_FLAGS, f"-I{build.CSRC}", "-shared", "-o",
               lib, src]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, p) in procs.items():
        log = p.communicate(timeout=build.BUILD_TIMEOUT_S)[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        built[name] = (lib, log)
    return built


def sass_counts(lib: str) -> dict:
    """kernel (demangled, shortened) -> opcode family counts and total."""
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, current = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            current = m[1]
            counts[current] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     line)
        if m and current:
            op = m[2].split(".")[0]
            if op == "NOP":
                continue
            counts[current]["total"] += 1
            counts[current][op] += 1
    try:
        names = subprocess.run(["c++filt"], input="\n".join(counts),
                               capture_output=True, text=True,
                               timeout=60).stdout.split("\n")
    except OSError:  # no demangler: the mangled names hold the same words
        names = list(counts)
    return {n: c for n, c in zip(names, counts.values())}


def strip_output_bytes(kernel: str, values: dict) -> int | None:
    """Output bytes per strip walk of a window_u8_strip kernel, times two:
    the kernel holds two unrolled walks (interior strips and checked ones)
    of nearly the same length, and a thread runs one. The strip's rows
    times four bytes a word times the body's words; None for another
    kernel."""
    if "window_u8_strip" not in kernel:
        return None
    int_body = any(k in kernel for k in ("ConvSep", "ConvDense"))
    words = values["kIntWords" if int_body else "kFieldWords"]
    return 2 * values["kStripRows"] * 4 * words


def event_us(fn, n: int, flush=None) -> float:
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--launches", type=int, default=30)
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("window_lab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    names = args.variants.split(",")
    built = build_variants(names)
    img, label = resolve_image()
    planar = to_planar_padded(img, make_layout(*img.shape[:2])).cuda()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    table = bodies()
    plains = {b: plain(planar) for b, (_, _, plain) in table.items()}
    result = {"image": label, "nvidia_smi": smi, "launches": args.launches,
              "variants": {}}
    print(f"{label} | {smi} | {args.launches} launches | µs warm / cold")
    for name in names:
        lib_path, log = built[name]
        regs = sorted({ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln})
        lib = ctypes.CDLL(lib_path)
        values = {**tuning(source()), **VARIANTS[name]}
        row = {"tuning": values, "ptxas": regs, "bodies": {}}
        for body, (entry, extra, _) in table.items():
            fn = getattr(lib, entry)
            fn.argtypes = list(build.SIGNATURES[entry])
            fn.restype = ctypes.c_int
            out = torch.empty_like(planar)
            c, hp, pitch = planar.shape

            def call(fn=fn, extra=extra, out=out):
                stream = torch.cuda.current_stream().cuda_stream
                rc = fn(planar.data_ptr(), out.data_ptr(), c, hp, pitch,
                        *extra, stream)
                if rc:
                    raise RuntimeError(f"{body}: cudaError {rc}")

            call()
            torch.cuda.synchronize()
            equal = torch.equal(out, plains[body])
            warm = event_us(call, args.launches)
            cold = event_us(call, args.launches, flush)
            row["bodies"][body] = {"equal": equal, "warm_us": warm,
                                   "cold_us": cold}
            print(f"  {name:8s} {body:16s} {'equal' if equal else 'DIFFERS'}"
                  f" warm {warm:7.2f} cold {cold:7.2f}")
        if args.sass:
            row["sass"] = {}
            for kernel, cnt in sass_counts(lib_path).items():
                fam = {f: sum(cnt[o] for o in ops)
                       for f, ops in FAMILIES.items()}
                short = kernel.split("(anonymous namespace)::")[-1]
                per = strip_output_bytes(kernel, values)
                row["sass"][kernel] = {"total": cnt["total"], **fam,
                                       "per_output_byte": (
                                           cnt["total"] / per if per else None)}
                top = [(op, n) for op, n in cnt.most_common(13)
                       if op != "total"][:12]
                row["sass"][kernel]["top"] = top
                print(f"  {name:8s} SASS {short[:60]:60s} {cnt['total']:6d}"
                      f" instr" + (f", {cnt['total'] / per:6.2f} per output "
                                   f"byte" if per else "") + " | "
                      + " ".join(f"{op} {n}" for op, n in top))
        for ln in regs:
            print(f"  {name:8s} {ln}")
        result["variants"][name] = row
    print(smi)
    print(json.dumps(result))
    bad = [(v, b) for v, r in result["variants"].items()
           for b, x in r["bodies"].items() if not x["equal"]]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
