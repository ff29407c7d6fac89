#!/usr/bin/env python3
"""The tile kernels of ``csrc/conv.cu``, timed on one GPU.

    python3 benchmarks/h100/conv_lab.py [--tree DIR] [--launches N]
                                        [--sides 3,5,...] [--rows 5,9,17]
                                        [--seps 5,7,...] [--rank1 7x7,...]
                                        [--sass] [--source NAME=PATH ...]

Imports ``dip_benchmark_tpu_torch`` from ``DIR`` (default: the checkout
that holds this script), so the same script times another tree, such as
a parent commit's ``git archive``; that tree's kernel library is built
there at first use. On the pad-8 planar ``(3, 2352, 3520)`` of the
3504x2336 benchmark image, both data models:

- the dense kh x kw sweep: square sides ``--sides`` (3, 5, 7, 9, 13, 17),
  then 1xN and Nx1 for N in ``--rows`` (5, 9, 17), each on every dense
  body of ``conv.cu`` the tree has, its C entry point called directly
  (3x3 and 5x5 too, which the builders send to the strip bodies):
  uint8 ``conv_tile_dense_u8`` and, where the tree has it,
  ``conv_tile_dense_mma_u8``, float32 ``conv_tile_dense_f32``; the mask
  a user's smoothing filter (``chip_smoke.smooth_weights``: weights 8 to
  55, which fit int8, over about 2^shift; a small 1xN or Nx1 one would
  take the two-pass form in the builders, not here);
- the two-pass kernels, their C entry points called directly (N 3 and 5
  too, which the builders send to the strip bodies): the separable form
  at each N of ``--seps`` (5, 7, 9, 13, 17; ``chip_smoke.py`` [3l]'s mask,
  a binomial row over 2^(N-1), whose weights pass int8 from N 11), uint8
  ``conv_tile_two_pass_u8`` rounded between the passes and float32
  ``conv_tile_sep_f32``; and uint8 ``conv_tile_two_pass_u8`` unrounded
  between, the form of a rank-1 packable mask (the JAX ``body_rank1``),
  at each kh x kw of ``--rank1`` (7x7, 17x17, 1x17, 9x3;
  ``chip_smoke.rank1_box``: a box filter, every other column of it at
  17x17 to stay packable).

Each output is held to its plain version on the whole buffer (tolerance
0) before it is timed: the median device time of ``--launches`` launches
from CUDA events behind a sleep kernel (``probe.event_us``; the same
input each launch: the uint8 input and output fit the 50 MB L2, the
float32 ones do not), beside the bound (``chip_smoke.bound_for`` of
``chip_smoke.conv_work``, as PERF.md's table reads it: bytes once at
3.35 TB/s against the operations at the int8 tensor-core or FP32 rate)
and the floor of the arithmetic the body issues (``imad_ms``: kh kw IMAD
an output at 64 a clock an SM, kh + kw for the two passes; ``fp32_ms``:
kh kw FMUL and kh kw - 1 FADD at 128, 2 N - 1 of each for the two passes;
132 SMs at 1.98 GHz). The yardstick and the timer are this
checkout's, whichever tree is timed. Prints the ``nvidia-smi`` name and power
limit, the registers and spills ``ptxas`` reported for ``conv.cu``'s
kernels when this run built the library (with ``--sass`` also the dense
kernels' static opcode counts, ``cuobjdump -sass``), and last one JSON
object with every number. ``--source NAME=PATH`` builds PATH, a variant
of ``csrc/conv.cu`` (a design under test, kept outside the package; it
may define a build knob and ``#include "conv.cu"``), on its own and times
its entries beside the library's in the same run, as ``kernel@NAME``.
Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import math
import os
import re
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
CLOCK_HZ = 1.98e9
SMS = 132
IMAD_S = 64 * SMS * CLOCK_HZ  # 32-bit integer multiply-adds a second
PAD = 8


def parse_args():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree", default=HERE,
                   help="checkout whose dip_benchmark_tpu_torch is timed")
    p.add_argument("--launches", type=int, default=50)
    p.add_argument("--sides", default="3,5,7,9,13,17")
    p.add_argument("--rows", default="5,9,17")
    p.add_argument("--seps", default="5,7,9,13,17",
                   help="N of the separable two-pass forms timed")
    p.add_argument("--rank1", default="7x7,17x17,1x17,9x3",
                   help="kh x kw of the unrounded two-pass form timed")
    p.add_argument("--sass", action="store_true",
                   help="print the dense kernels' static SASS opcode counts")
    p.add_argument("--source", action="append", default=[],
                   metavar="NAME=PATH",
                   help="also time the entries of PATH, a variant of "
                        "csrc/conv.cu built on its own, as NAME (repeatable)")
    return p.parse_args()


ENTRIES = ("dip_conv_tile_dense_u8", "dip_conv_tile_dense_mma_u8",
           "dip_conv_tile_dense_f32", "dip_conv_tile_two_pass_u8",
           "dip_conv_tile_sep_f32")


def build_variants(build, specs) -> list:
    """(NAME, library) for each NAME=PATH of ``specs``: PATH (a variant of
    csrc/conv.cu) compiled on its own with the library's flags into
    build/conv_lab/NAME/, one nvcc process each, all started together; its
    entries typed."""
    jobs = []
    for spec_ in specs:
        name, path = spec_.split("=", 1)
        out_dir = os.path.join(HERE, "build", "conv_lab", name)
        os.makedirs(out_dir, exist_ok=True)
        lib = os.path.join(out_dir, "libconv.so")
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", build.CSRC,
               "-shared", "-o", lib, path]
        jobs.append((name, path, lib, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    out = []
    for name, path, lib, cmd, proc in jobs:
        log = proc.communicate(timeout=900)[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)}\n{log}")
        regs = ptxas_report(log)
        spill = max((r.get("spill_stores", 0) + r.get("spill_loads", 0)
                     for r in regs.values()), default=0)
        print(f"  variant {name}: {path}; spill bytes {spill}")
        print_registers(regs, f"  {name} ptxas")
        cdll = ctypes.CDLL(lib)
        for entry in ENTRIES:
            getattr(cdll, entry).argtypes = list(build.SIGNATURES[entry])
            getattr(cdll, entry).restype = ctypes.c_int
        out.append((name, cdll))
    return out


def variant_launcher(cdll, entry: str, extra):
    """A call of ``entry`` of a variant library on a planar, into a new
    output, on the current stream."""
    def fn(p):
        out = torch.empty_like(p)
        c, hp, pitch = p.shape
        status = getattr(cdll, entry)(
            p.data_ptr(), out.data_ptr(), c, hp, pitch, *extra,
            torch.cuda.current_stream().cuda_stream)
        if status:
            raise RuntimeError(f"{entry}: cudaError {status}")
        return out
    return fn


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


FAMILIES = ("conv_tile_dense_mma_u8", "conv_tile_dense_u8",
            "conv_tile_dense_f32", "conv_tile_two_pass_u8", "conv_tile_sep_f32")


def kernel_name(mangled: str) -> str | None:
    """``family`` or ``family<N>``, ``family<KH,KW>`` (a template
    instantiation) of one of conv.cu's kernels, from its mangled name;
    None for other kernels."""
    family = next((k for k in FAMILIES if k in mangled), None)
    if family is None:
        return None
    m = re.search(family + r"I((?:L[ib]\d+E)+)E", mangled)
    if not m:
        return family
    args = re.findall(r"L[ib](\d+)E", m[1])
    return f"{family}<{','.join(args)}>"


def template_args(name: str) -> tuple:
    """The template arguments of ``family<...>`` as ints, () for none."""
    inner = name.partition("<")[2].rstrip(">")
    return tuple(int(x) for x in inner.split(",") if x)


def print_registers(report: dict, prefix: str) -> None:
    """One line a family of ``ptxas_report``: each instantiation's
    registers, and the family's largest spill."""
    for family in FAMILIES:
        mine = {k: r for k, r in report.items()
                if k.split("<")[0] == family}
        if mine:
            regs = " ".join(f"{k[len(family):]}:{r.get('registers')}"
                            for k, r in sorted(
                                mine.items(),
                                key=lambda kv: template_args(kv[0])))
            spill = max(r.get("spill_stores", 0) + r.get("spill_loads", 0)
                        for r in mine.values())
            print(f"{prefix} {family}: registers {regs}; spill bytes "
                  f"{spill}")


def ptxas_report(log: str) -> dict:
    """kernel -> registers, spill store and load bytes of conv.cu's entry
    functions in an nvcc -Xptxas -v log."""
    out = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = kernel_name(m[1])
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(name, {}).update(spill_stores=int(m[1]),
                                            spill_loads=int(m[2]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, {})["registers"] = int(m[1])
            name = None
    return out


def sass_counts(nvcc: str, lib: str, sides=(1, 7, 17),
                two_pass=(5, 9, 17)) -> dict:
    """conv.cu dense kernel at ``sides``, two-pass kernel at ``two_pass``
    (uint8: kw == kh and any kw, 1 and 2 digits) -> its static SASS opcode
    counts (NOPs left out), from ``cuobjdump -sass`` of the library."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    keep = {f"{k}<{n}>" for k in FAMILIES[:3] for n in sides}
    keep |= {f"conv_tile_two_pass_u8<{n},{w},{d},1>" for n in two_pass
             for w in (n, 0) for d in (1, 2)}
    keep |= {f"conv_tile_sep_f32<{n}>" for n in two_pass}
    counts, current = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            current = kernel_name(m[1])
            current = current if current in keep else None
            if current:
                counts[current] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     line)
        if m and current and m[2] != "NOP":
            counts[current]["total"] += 1
            counts[current][m[2].split(".")[0]] += 1
    return {k: dict(c.most_common(24)) for k, c in counts.items()}


def two_pass_args(window, u, v, shift, round_between, clamp_rows,
                  clamp_out) -> tuple:
    """(name, C entry, arguments after the geometry) of the uint8 two-pass
    kernel, built here so that a parent tree without
    ``window.two_pass_launch`` is timed the same way."""
    u, v = np.ravel(u), np.ravel(v)
    return ("conv_tile_two_pass_u8", "dip_conv_tile_two_pass_u8",
            (len(u), len(v), window._int_array(u), window._int_array(v),
             int(shift), int(round_between), int(clamp_rows),
             int(clamp_out)))


def main() -> int:
    args = parse_args()
    if not torch.cuda.is_available():
        print("conv_lab: needs a CUDA device", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from dip_benchmark_tpu_torch import spec
    from dip_benchmark_tpu_torch.ops import f32, kernels, window
    from dip_benchmark_tpu_torch.ops.kernels import build
    from dip_benchmark_tpu_torch.utils.image import (
        make_layout, to_planar_padded, to_planar_padded_f32)
    from dip_benchmark_tpu_torch.utils.testimage import resolve_image
    import dip_benchmark_tpu_torch
    here = os.path.dirname(os.path.dirname(dip_benchmark_tpu_torch.__file__))
    if not os.path.samefile(here, tree):
        raise SystemExit(f"conv_lab: imported {here}, not {tree}")
    # This checkout's yardstick and event timer, on the tree's package
    # (already imported): probe puts this checkout first on the path.
    import probe
    import chip_smoke
    if not os.path.samefile(os.path.dirname(chip_smoke.__file__), HERE):
        raise SystemExit(f"conv_lab: imported {chip_smoke.__file__}, not "
                         f"this checkout's chip_smoke.py")

    card = smi()
    print(f"card: {card}")
    print(f"tree: {tree}")
    build.load()
    ptxas = ptxas_report(build.build_log)
    print_registers(ptxas, "  ptxas")
    if not ptxas:
        print("  ptxas: the library was built before this run (no log)")
    sass = sass_counts(build.nvcc_path(), build.library_path()) \
        if args.sass else {}
    for name, c in sorted(sass.items()):
        print(f"  sass {name}: {c}")

    img, source = resolve_image()
    layout = make_layout(*img.shape[:2], pad=PAD)
    planars = {"uint8": to_planar_padded(img, layout).cuda(),
               "float32": to_planar_padded_f32(img, layout).cuda()}
    print(f"image: {source} {img.shape[1]}x{img.shape[0]}, planar "
          f"{tuple(planars['uint8'].shape)}")
    mma = "dip_conv_tile_dense_mma_u8" in build.SIGNATURES

    variants = build_variants(build, args.source)

    def launcher(name, entry, extra):
        return lambda p: window._launch_window(name, entry, p, *extra)

    def timed_bodies(label, dtype, name, entry, extra, plain, kh, kw,
                     form="dense"):
        run(label, dtype, name, launcher(name, entry, extra), plain, kh, kw,
            form)
        for vname, cdll in variants:
            run(label, dtype, f"{name}@{vname}",
                variant_launcher(cdll, entry, extra), plain, kh, kw, form)

    sides = [int(s) for s in args.sides.split(",") if s]
    rows = [int(s) for s in args.rows.split(",") if s]
    shapes = ([(s, s) for s in sides] + [(1, n) for n in rows]
              + [(n, 1) for n in rows])
    entries = []

    def run(label, dtype, name, fn, plain, kh, kw, form):
        planar = planars[dtype]
        got = fn(planar)
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, plain(planar)))
        del got
        ms = probe.event_us(lambda: fn(planar), args.launches) / 1e3
        work = chip_smoke.conv_work(dtype, form, kh if form == "separable"
                                    else (kh, kw))
        bound_ms, bound_by = chip_smoke.bound_for(work, planar)
        positions = planar.numel() // planar.shape[-3]
        floor = ({"imad_ms": 1e3 * work[0] * positions / IMAD_S}
                 if dtype == "uint8" else
                 {"fp32_ms": 1e3 * work * positions / chip_smoke.F32_OPS_S})
        e = {"label": label, "dtype": dtype, "kernel": name, "kh": kh,
             "kw": kw, "equal": equal, "ms": ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "share": bound_ms / ms, **floor}
        entries.append(e)
        extra = " ".join(f"{k} {v:.4f}" for k, v in floor.items())
        print(f"  {dtype:7s} {label:11s} {name:30s} {ms:9.4f} ms | bound "
              f"{bound_ms:.4f} ({e['bound_by']}, {e['share']:.2f}) | "
              f"{extra} | {'equal' if equal else 'DIFFERS'}", flush=True)

    for kh, kw in shapes:
        rng = np.random.default_rng(100 * kh + kw)
        mask, shift = chip_smoke.smooth_weights(rng, kh, kw)
        label = f"{kh}x{kw}"
        clamp = int(window.clamps(mask, shift))
        u8_plain = (lambda p, m=mask, s=shift:
                    window.conv_dense_plain(p, m, s))
        timed_bodies(label, "uint8", "conv_tile_dense_u8",
                     "dip_conv_tile_dense_u8",
                     (kh, kw, window._int_array(mask), shift, clamp),
                     u8_plain, kh, kw)
        if mma:
            win = window.mma_windows(mask).ravel()
            timed_bodies(label, "uint8", "conv_tile_dense_mma_u8",
                         "dip_conv_tile_dense_mma_u8",
                         (kh, kw, (ctypes.c_uint * win.size)(*win.tolist()),
                          shift, clamp), u8_plain, kh, kw)
        timed_bodies(label, "float32", "conv_tile_dense_f32",
                     "dip_conv_tile_dense_f32",
                     (kh, kw, f32._float_array(spec.mask_float(mask, shift))),
                     lambda p, m=mask, s=shift: f32.conv_dense_plain(p, m, s),
                     kh, kw)
    for n in [int(x) for x in args.seps.split(",") if x]:
        row = np.array([[math.comb(n - 1, k) for k in range(n)]], np.int32)
        shift = n - 1
        name, entry, extra = two_pass_args(
            window, row, row, shift, True, window.clamps(row, shift),
            window.clamps(row, shift))
        timed_bodies(f"sep {n}", "uint8", name, entry, extra,
                     lambda p, r=row, s=shift: window.conv_sep_plain(
                         p, r, r.T.copy(), s), n, n, "separable")
        weights = f32._float_array(spec.mask_float(row, shift))
        timed_bodies(f"sep {n}", "float32", "conv_tile_sep_f32",
                     "dip_conv_tile_sep_f32", (n, weights, weights),
                     lambda p, r=row, s=shift: f32.conv_sep_plain(
                         p, r, r.T.copy(), s), n, n, "separable")
    for shape in [x for x in args.rank1.split(",") if x]:
        kh, kw = (int(x) for x in shape.split("x"))
        u, v = chip_smoke.rank1_box(kh, kw)
        shift = int(round(math.log2(int(u.sum()) * int(v.sum()))))
        name, entry, extra = two_pass_args(window, u, v, shift, False,
                                           False, True)
        timed_bodies(f"rank1 {shape}", "uint8", name, entry, extra,
                     lambda p, u=u, v=v, s=shift: window.conv_rank1_plain(
                         p, u, v, s), kh, kw, "rank1")
    kernels.reset_launches()
    ok = all(e["equal"] for e in entries)
    print(json.dumps({"card": card, "tree": tree, "image": source,
                      "ptxas": ptxas, "sass": sass, "entries": entries,
                      "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
