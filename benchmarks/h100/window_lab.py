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

Then the morphology library surface's generic elements (``--taps``, names
of ``TAP_ELEMENTS``; '' skips), on a layout whose halo fits the element
(``pad=8`` for the 17x17 square): each element's erosion and dilation in
uint8 and erosion in float32 on the ``Taps`` kernels of ``window.cu`` and
``f32.cu`` built with each variant of ``taps.cuh``'s constants
(``--taps-variants``, names of ``TAPS_VARIANTS``; one library per source
and variant under ``build/window_lab/taps/``), the program built for the
variant's ``kTapsRows`` (``--programs``, names of ``PROGRAMS``: the one
``window.taps_program`` ships, or the one of another table set): the
output against
``morphology_plain`` (whole buffer, tolerance 0), the median device time
L2-warm and L2-cold, and the program's shared-memory reads, writes and
min/max operations an output. The 3x3 square and cross run both on the
kernels the make_* functions route them to (``MinRect``, ``MinPlus``,
``MaxRect``, ``MaxPlus``, the float32 ``window_f32_strip`` bodies; the package's
library) and on ``Taps``. With ``--sass`` also the static SASS of each
variant's ``window_taps`` kernels.
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

import numpy as np  # noqa: E402

from chip_smoke import DENSE_MASKS, DIAMOND_5X5  # noqa: E402
from dip_benchmark_tpu_torch import spec  # noqa: E402
from dip_benchmark_tpu_torch.ops import f32, window  # noqa: E402
from dip_benchmark_tpu_torch.ops.kernels import build  # noqa: E402
from dip_benchmark_tpu_torch.utils.image import (  # noqa: E402
    make_layout, to_planar_padded, to_planar_padded_f32)
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

def disc(radius: int) -> np.ndarray:
    """The digital disc dy^2 + dx^2 <= radius^2."""
    d = np.arange(-radius, radius + 1)
    return d[:, None] ** 2 + d[None, :] ** 2 <= radius ** 2


RING_5X5 = np.ones((5, 5), bool)
RING_5X5[1:4, 1:4] = False
# The library surface's elements timed in the taps section: name ->
# (element, layout halo).
TAP_ELEMENTS = {
    "square-3x3": (spec.SQUARE_MASK_3X3, 2),
    "cross-3x3": (spec.CROSS_MASK_3X3, 2),
    "diamond-5x5": (DIAMOND_5X5, 2),
    "square-5x5": (np.ones((5, 5), bool), 2),
    "row-1x5": (np.ones((1, 5), bool), 2),
    "ring-5x5": (RING_5X5, 2),
    "disc-9x9": (disc(4), 4),
    "square-17x17": (np.ones((17, 17), bool), 8),
}
TAPS_TUNING = ("kTapsRowsU8", "kTapsRowsF32", "kTapsChunk")
TAPS_VARIANTS = {
    "default": {},
    # The output instruction takes one chunk a thread: rows / chunk *
    # frame words = 256 threads.
    "chunk8": {"kTapsChunk": 8, "kTapsRowsU8": 32, "kTapsRowsF32": 16},
    # Diagnostics, whose outputs differ: one term an instruction; no
    # global loads; almost no global stores; the output instruction alone
    # (with the loads and stores: the fixed cost of a tile).
    "oneterm": {"edits": (
        ("for (int t = first; t < end; ++t) E::accumulate(acc, at, "
         "terms[t]);", "E::accumulate(acc, at, terms[first]);"),)},
    "nofetch": {"edits": (
        ("    Loads::fetch(tile, g, v);\n    E::put(v, slots, g);", ""),)},
    "nostore": {"edits": (
        ("  E::store(slots, tile, g);",
         "  if (prog.hx > 64) E::store(slots, tile, g);"),)},
    "lastonly": {"edits": (
        ("for (int i = 0; i < prog.instrs; ++i) {",
         "for (int i = prog.instrs - 1; i < prog.instrs; ++i) {"),)},
}
TAPS_DIAGNOSTICS = ("oneterm", "lastonly", "nofetch", "nostore")
# Programs of an element for a tile of ``rows`` output rows: name ->
# function of (taps, rows), None where the program does not fit.
PROGRAMS = {
    "shipped": window.taps_program,
    # a table for each run length of the element
    "runs": lambda taps, rows: _fitting(window.tap_runs(taps), rows),
    # tables of the powers of two up to the longest run
    "pow2": lambda taps, rows: _fitting(window.tap_runs(taps, "pow2"), rows),
}
TAPS_ENTRIES = ("dip_erosion_taps_u8", "dip_dilation_taps_u8",
                "dip_erosion_taps_f32")
# Opcode families counted in the SASS of each kernel.
FAMILIES = {"minmax": ("VIMNMX", "VMNMX", "IMNMX", "VABSDIFF4"),
            "prmt": ("PRMT",), "shf": ("SHF",), "imad": ("IMAD", "IMUL"),
            "ldg": ("LDG",), "stg": ("STG",), "shfl": ("SHFL",)}


def _fitting(runs, rows: int):
    prog = window._compile(runs, rows)
    return prog if window._fits(prog) else None


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
                   out: str = OUT, append: str = "",
                   inline: tuple = ()) -> dict:
    """variant -> (library path, ptxas output): ``src_name`` from csrc/,
    with the code ``append`` after it and the headers ``inline`` pasted in
    place of their ``#include``, with each variant's constants
    (``variants``, default ``VARIANTS``) substituted, each into a library
    of its own under ``out``; all compiled at once."""
    variants = VARIANTS if variants is None else variants
    os.makedirs(out, exist_ok=True)
    nvcc = build.nvcc_path()
    text = source(src_name) + append
    for header in inline:
        text = text.replace(f'#include "{header}"', source(header))
    stem = src_name.rsplit(".", 1)[0]
    procs = {}
    for name in names:
        src = os.path.join(out, f"{stem}_{name}.cu")
        lib = os.path.join(out, f"{stem}_{name}.so")
        variant = text
        for k, v in variants[name].items():
            if k == "edits":  # (old, new) source edits of a diagnostic
                for old, new in v:
                    if old not in variant:
                        raise ValueError(f"{name}: no {old!r} in {src_name}")
                    variant = variant.replace(old, new)
                continue
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


def taps_libs(names) -> dict:
    """variant -> {entry: ctypes function} of window.cu and f32.cu built
    with ``TAPS_VARIANTS[variant]``'s constants in taps.cuh."""
    out = os.path.join(OUT, "taps")
    libs = {}
    for src in ("window.cu", "f32.cu"):
        built = build_variants(names, TAPS_VARIANTS, src, out,
                               inline=("taps.cuh",))
        for name, (lib_path, log) in built.items():
            lib = ctypes.CDLL(lib_path)
            fns = libs.setdefault(name, {"ptxas": [], "libs": []})
            fns["libs"].append(lib_path)
            fns["ptxas"] += sorted({ln.strip() for ln in log.splitlines()
                                    if "registers" in ln or "spill" in ln})
            for entry in TAPS_ENTRIES:
                if hasattr(lib, entry):
                    fn = getattr(lib, entry)
                    fn.argtypes = list(build.SIGNATURES[entry])
                    fn.restype = ctypes.c_int
                    fns[entry] = fn
    return libs


def taps_section(img, names, variants, programs, launches: int, flush,
                 result: dict) -> list:
    """Each element of ``names`` in both data models: the route that the
    make_* functions take where it is not Taps (the 3x3 square and cross),
    and the Taps kernels of every variant (forced for the 3x3 elements)
    running each of ``programs`` that fits and differs from those before:
    equality with the plain version, µs warm and cold, and the program's
    counts; returns the cases that differ."""
    h, w = img.shape[:2]
    libs = taps_libs(variants)
    bad = []
    print("taps: element | kernel | warm / cold µs | program an output")
    for el in names:
        mask, pad = TAP_ELEMENTS[el]
        taps = window.mask_to_taps(mask)
        layout = make_layout(h, w, pad=pad)
        planars = {"uint8": to_planar_padded(img, layout).cuda(),
                   "float32": to_planar_padded_f32(img, layout).cuda()}
        cases = []
        if window._tap_structure(taps) != "generic" and pad == 2:
            cases += [("routed", "uint8", "min",
                       window.make_erosion(layout, taps)),
                      ("routed", "uint8", "max",
                       window.make_dilation(layout, taps)),
                      ("routed", "float32", "min",
                       f32.make_erosion(layout, taps))]
            cases = [c for c in cases if "Taps" not in c[3].kernel]
        for v in variants:
            knobs = {**tuning(source("taps.cuh"), TAPS_TUNING),
                     **TAPS_VARIANTS[v]}
            for dtype, reduce in (("uint8", "min"), ("uint8", "max"),
                                  ("float32", "min")):
                rows = knobs["kTapsRowsU8" if dtype == "uint8"
                             else "kTapsRowsF32"]
                name, entry = window.MORPHOLOGY_KERNELS[(dtype, reduce,
                                                         "taps")]
                seen = []
                for pname in programs:
                    prog = PROGRAMS[pname](taps, rows)
                    if prog is None or prog.instrs in seen:
                        continue
                    seen.append(prog.instrs)
                    words = window._int_array(prog.encode())

                    def op(p, fn=libs[v][entry], e=entry, words=words):
                        out = torch.empty_like(p)
                        rc = fn(p.data_ptr(), out.data_ptr(), *p.shape,
                                words, len(words),
                                torch.cuda.current_stream().cuda_stream)
                        if rc:
                            raise RuntimeError(f"{e}: cudaError {rc}")
                        return out

                    op.kernel = f"{name} [{v}, {pname} {prog.tables}]"
                    op.stats = prog.stats()
                    cases.append((v, dtype, reduce, op))
        for v, dtype, reduce, op in cases:
            planar = planars[dtype]
            plain = window.morphology_plain(
                planar, taps, torch.minimum if reduce == "min"
                else torch.maximum)
            equal = torch.equal(op(planar), plain)
            warm = event_us(lambda: op(planar), launches)
            cold = event_us(lambda: op(planar), launches, flush)
            row = {"element": el, "variant": v, "dtype": dtype,
                   "reduce": reduce, "kernel": op.kernel, "pad": pad,
                   "taps": len(taps), "shape": list(planar.shape),
                   "equal": equal, "warm_us": warm, "cold_us": cold,
                   "program": getattr(op, "stats", None)}
            result["taps"].append(row)
            if not equal and v not in TAPS_DIAGNOSTICS:
                bad.append((el, v, dtype, reduce))
            stats = row["program"]
            print(f"  {el:13s} {dtype:7s} {reduce} {op.kernel:52s} "
                  f"{'equal' if equal else 'DIFFERS'} warm {warm:8.2f} "
                  f"cold {cold:8.2f}" + (
                      f" | reads {stats['reads']:.2f} writes "
                      f"{stats['writes']:.2f} ops {stats['ops']:.2f} slots "
                      f"{stats['slots']}" if stats else ""))
        del planars
    for v in variants:
        for ln in libs[v]["ptxas"]:
            print(f"  {v:8s} {ln}")
    result["taps_libs"] = {v: libs[v]["libs"] for v in variants}
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--launches", type=int, default=30)
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--taps", default=",".join(TAP_ELEMENTS))
    ap.add_argument("--taps-variants", default="default")
    ap.add_argument("--programs", default="shipped")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("window_lab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    names = [n for n in args.variants.split(",") if n]
    built = build_variants(names)
    img, label = resolve_image()
    planar = to_planar_padded(img, make_layout(*img.shape[:2])).cuda()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    table = bodies()
    plains = {b: plain(planar) for b, (_, _, plain) in table.items()}
    result = {"image": label, "nvidia_smi": smi, "launches": args.launches,
              "variants": {}, "taps": []}
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
    elements = [e for e in args.taps.split(",") if e]
    taps_variants = [v for v in args.taps_variants.split(",") if v]
    programs = [p for p in args.programs.split(",") if p]
    bad = taps_section(img, elements, taps_variants, programs, args.launches,
                       flush, result) if elements else []
    if args.sass and elements:
        result["taps_sass"] = {}
        for v in taps_variants:
            for lib_path in result["taps_libs"][v]:
                for kernel, cnt in sass_counts(lib_path).items():
                    if "window_taps" not in kernel:
                        continue
                    short = kernel.split("(")[0].split("::")[-1] + " " + (
                        "u8 " + ("Max" if "TapsMax" in kernel else "Min")
                        if "U8" in kernel else "f32 Min")
                    top = [(op, n) for op, n in cnt.most_common(13)
                           if op != "total"][:12]
                    result["taps_sass"][f"{v} {short}"] = {
                        "total": cnt["total"], "top": top}
                    print(f"  {v:8s} SASS {short:28s} {cnt['total']:6d} "
                          f"instr | " + " ".join(f"{op} {n}"
                                                 for op, n in top))
    print(smi)
    print(json.dumps(result))
    bad += [(v, b) for v, r in result["variants"].items()
            for b, x in r["bodies"].items() if not x["equal"]]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
