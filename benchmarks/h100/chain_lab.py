#!/usr/bin/env python3
"""Build settings of ``chain_u8``, ``chain_f32``, ``pipeline_u8`` and
``window_f32_strip``, timed on one GPU.

    python3 benchmarks/h100/chain_lab.py [--chain NAME,...]
        [--stream NAME,...] [--f32 NAME,...] [--fchain NAME,...]
        [--pipe NAME,...] [--launches N] [--sass]

Compiles ``csrc/chain.cu`` once per variant of ``chain_u8``'s tile
constants (``CHAIN_VARIANTS``: the tile's words and rows, the halo vector,
blocks an SM, loads in flight) and once per variant of ``chain_f32``'s
(``F32_CHAIN_VARIANTS``: tile rows, float4 a lane, warps across a row,
threads, blocks an SM, i.e. the register cap, loads in flight), once per
variant of the other u8 design that ``chain_stream.cuh`` appends to it
(``STREAM_VARIANTS``: one ring for all stages, no shared memory; the
strip's rows), ``csrc/pipeline.cu`` once per variant of its strip walk
(``PIPE_VARIANTS``: strip rows, words a lane, warps a block, rows loaded
ahead), and ``csrc/f32.cu`` once per variant of the strip skeleton's
(``F32_VARIANTS``: strip rows, rows loaded ahead, float4 a thread, threads
a block), one ``nvcc`` process per variant, all started together, each
into a library of its own under ``build/chain_lab/``
(``window_lab.build_variants``). Then, on the 3504x2336 benchmark image:
for every variant of either u8 chain design, ``chip_smoke.CHAINS`` C1-C4
in the uint8 model, and for every ``chain_f32`` variant the same chains
in the float32 model (each on a planar baked with its halo); for every
``pipeline_u8`` variant, stacks of ``PIPE_BATCHES`` images; for every
variant of ``f32.cu``, the five convolution bodies of the float32 model.
Each output is held to its plain version on the whole buffer (tolerance 0)
and timed: the median device time of N launches from CUDA events behind a
sleep kernel, L2-warm (the same input again) and L2-cold (a 256 MB write
between launches).

With ``--sass`` it also prints, from ``cuobjdump -sass`` of each library:
for ``window_f32_strip`` kernels, whose strip walk is unrolled, the static
instruction count per output (two walks, interior and checked, of
kF32StripRows rows of 4 kF32Vecs outputs); for ``chain_u8`` and
``chain_f32``, whose stage walks are loops, each innermost loop that reads
and writes shared memory (a stage walk) with its length, the outputs it
stores an iteration and so its instructions per output, and its opcode
families, and for ``chain_f32`` each chain's sum over its stages; for
``pipeline_u8`` its loops and instructions per output byte; for
``chain_u8_stream``, its one walk (the loop that stores to global memory)
the same way. Prints the ``nvidia-smi`` name and power limit, and last one
JSON object with every number. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from chip_smoke import CHAINS  # noqa: E402
from dip_benchmark_tpu_torch import spec  # noqa: E402
from dip_benchmark_tpu_torch.models import chain  # noqa: E402
from dip_benchmark_tpu_torch.models.pipeline import (  # noqa: E402
    fused_pipeline_plain)
from dip_benchmark_tpu_torch.ops import f32  # noqa: E402
from dip_benchmark_tpu_torch.ops.kernels import build  # noqa: E402
from dip_benchmark_tpu_torch.utils.image import (  # noqa: E402
    make_layout, stack_planar_padded, to_planar_padded, to_planar_padded_f32)
from dip_benchmark_tpu_torch.utils.testimage import resolve_image  # noqa: E402
from window_lab import (FAMILIES, build_variants, event_us,  # noqa: E402
                        sass_counts, source, tuning)

OUT = os.path.join(ROOT, "build", "chain_lab")
CHAIN_KNOBS = ("kTileWords", "kTileRows", "kU8BlocksPerSM", "kHaloWords",
               "kLoadBatch")
CHAIN_VARIANTS = {
    "default": {},
    "halo2": {"kHaloWords": 2},
    "rows64": {"kTileRows": 64, "kU8BlocksPerSM": 4},
    "words128": {"kTileWords": 128, "kU8BlocksPerSM": 1},
    "batch4": {"kLoadBatch": 4},
}
# The other design: chain_stream.cuh appended to chain.cu, C1-C4 fixed.
STREAM_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "chain_stream.cuh")
STREAM_KNOBS = ("kStreamRows", "kStreamWarps")
STREAM_VARIANTS = {
    "stream": {},
    "stream128": {"kStreamRows": 128},
}
STREAM_WHICH = {"C1": 1, "C2": 2, "C3": 3, "C4": 4}
F32_KNOBS = ("kF32StripRows", "kF32PrefetchRows", "kF32Vecs",
             "kF32StripThreads")
F32_VARIANTS = {
    "default": {},
    "rows8": {"kF32StripRows": 8},
    "vecs2": {"kF32Vecs": 2},
    "threads256": {"kF32StripThreads": 256},
}
# chain_f32's tile (chain.cu): output rows of a tile, float4 a lane, warps
# across a tile row, threads and blocks an SM (the register cap), float4
# loads in flight a thread.
F32_CHAIN_KNOBS = ("kChainRows", "kChainVecs", "kChainGroups",
                   "kChainThreads", "kChainBlocksPerSM", "kChainLoadBatch")
F32_CHAIN_VARIANTS = {
    "default": {},
    "rows64": {"kChainRows": 64},
    "rows96": {"kChainRows": 96, "kChainBlocksPerSM": 1},
    "t320": {"kChainThreads": 320},
    "load12": {"kChainLoadBatch": 12},
    "vecs2": {"kChainVecs": 2, "kChainThreads": 256, "kChainRows": 64,
              "kChainBlocksPerSM": 1},
    "groups2": {"kChainGroups": 2, "kChainThreads": 512, "kChainRows": 64,
                "kChainBlocksPerSM": 1},
}
# pipeline_u8's strip walk (pipeline.cu): output rows of a strip, 32-bit
# words a lane (kTileW is 128 bytes a word), warps a block, rows loaded
# ahead.
PIPE_KNOBS = ("kPipeRows", "kPipeWords", "kTileW", "kPipeWarps",
              "kPipeAhead", "kPipeAheadOne")
PIPE_VARIANTS = {
    "default": {},
    "rows4": {"kPipeRows": 4},
    "rows16": {"kPipeRows": 16},
    "warps2": {"kPipeWarps": 2},
    "ahead3": {"kPipeAhead": 3},
    "one4": {"kPipeAheadOne": 4},
    "words8": {"kPipeWords": 8, "kTileW": 1024},
}
PIPE_BATCHES = (1, 2, 4, 8)
LOOP_FAMILIES = {**FAMILIES, "lds": ("LDS",), "sts": ("STS",),
                 "ldgsts": ("LDGSTS",)}


def knobs(text: str, names) -> dict:
    """``tuning`` for the knobs ``text`` has (an older source lacks some)."""
    return tuning(text, [k for k in names
                         if re.search(rf"constexpr int {k} = -?\d+;", text)])


def f32_bodies() -> dict:
    """label -> (C entry, arguments after the geometry, plain version)."""
    out = {"Blur3x3": ("dip_blur3x3_f32", (), f32.blur3x3_plain)}
    for n, mask, shift in ((3, spec.BLUR_3X3_INT, spec.BLUR_3X3_SHIFT),
                           (5, spec.BLUR_5X5_INT, spec.BLUR_5X5_SHIFT)):
        out[f"ConvDense<{n},{n}>"] = (
            "dip_conv_dense_f32",
            (n, n, f32._float_array(spec.mask_float(mask, shift))),
            lambda p, m=mask, s=shift: f32.conv_dense_plain(p, m, s))
    for n, row, col, shift in (
            (3, spec.BLUR_1X3_INT, spec.BLUR_3X1_INT, spec.BLUR_SEP3_SHIFT),
            (5, spec.BLUR_1X5_INT, spec.BLUR_5X1_INT, spec.BLUR_SEP5_SHIFT)):
        out[f"ConvSep<{n}>"] = (
            "dip_conv_sep_f32",
            (n, f32._float_array(spec.mask_float(row, shift)),
             f32._float_array(spec.mask_float(col, shift))),
            lambda p, r=row, c=col, s=shift: f32.conv_sep_plain(p, r, c, s))
    return out


def chain_cases(img) -> dict:
    """chain -> (planar on the card, C entry arguments after the two
    pointers, plain output)."""
    out = {}
    for name, cols in CHAINS.items():
        layout = make_layout(*img.shape[:2],
                             pad=max(2, *chain.check_chain(cols)))
        planar = to_planar_padded(img, layout).cuda()
        fn = chain.make_fused_chain(layout, cols).prepare(planar.device)
        words = fn._device_words[planar.device]
        c, hp, pitch = planar.shape
        count = 1 if fn.gray_first else c
        args = (count, hp, pitch, int(fn.gray_first), words.data_ptr(),
                fn._host_words, len(fn._host_words),
                *spec.GRAYSCALE_WEIGHTS_INT_RGB, spec.GRAYSCALE_SHIFT)
        out[name] = (planar, args,
                     chain.fused_chain_plain(planar, cols, "uint8"), words)
    return out


def chain_cases_f32(img) -> dict:
    """The same for chain_f32, on float32 planars."""
    out = {}
    for name, cols in CHAINS.items():
        layout = make_layout(*img.shape[:2],
                             pad=max(2, *chain.check_chain(cols)))
        planar = to_planar_padded_f32(img, layout).cuda()
        fn = chain.make_fused_chain_f32(layout, cols).prepare(planar.device)
        words = fn._device_words[planar.device]
        c, hp, pitch = planar.shape
        count = 1 if fn.gray_first else c
        args = (count, hp, pitch, int(fn.gray_first), words.data_ptr(),
                fn._host_words, len(fn._host_words), *f32.LUMA)
        out[name] = (planar, args,
                     chain.fused_chain_plain(planar, cols, "float32"), words)
    return out


def pipe_cases(img) -> dict:
    """B -> (stack of B benchmark images on the card, C entry arguments
    after the two pointers, plain output)."""
    layout = make_layout(*img.shape[:2])
    out = {}
    for b in PIPE_BATCHES:
        stack = stack_planar_padded(np.stack([img] * b), layout).cuda()
        _, _, hp, pitch = stack.shape
        out[b] = (stack, (b, hp, pitch), fused_pipeline_plain(stack))
    return out


def bind(lib_path: str, entry: str):
    fn = getattr(ctypes.CDLL(lib_path), entry)
    fn.argtypes = list(build.SIGNATURES[entry])
    fn.restype = ctypes.c_int
    return fn


def timed_case(fn, planar, args, plain, launches, flush) -> dict:
    """Equality with the plain version, warm and cold µs of one kernel."""
    out = torch.empty_like(planar)

    def call():
        rc = fn(planar.data_ptr(), out.data_ptr(), *args,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"cudaError {rc}")

    call()
    torch.cuda.synchronize()
    return {"equal": torch.equal(out, plain),
            "warm_us": event_us(call, launches),
            "cold_us": event_us(call, launches, flush)}


def sass_lines(lib: str) -> dict:
    """kernel (mangled) -> [(address, opcode, branch target or None,
    opcode with its suffixes)]."""
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    kernels, labels, current = {}, {}, None
    pending = []
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            current = m[1]
            kernels[current], labels[current] = [], {}
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m and current:
            pending.append(m[1])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)"
                     r"(.*)", line)
        if m and current:
            addr, full = int(m[1], 16), m[3]
            op = full.split(".")[0]
            for lab in pending:
                labels[current][lab] = addr
            pending = []
            target = None
            if op == "BRA":
                t = re.search(r"(0x[0-9a-f]+|\.L_x_\d+)", m[4])
                target = t[1] if t else None
            kernels[current].append((addr, op, target, full))
    for k, ins in kernels.items():
        kernels[k] = [(a, op, (int(t, 16) if t and t.startswith("0x")
                               else labels[k].get(t)) if t else None, full)
                      for a, op, t, full in ins]
    return kernels


# Bytes a store writes, by its width suffix (no suffix: 32 bits).
STORE_BYTES = {"U8": 1, "S8": 1, "U16": 2, "S16": 2, "64": 8, "128": 16}


def stored(full: str) -> int:
    """Bytes written by the store ``full`` (opcode with suffixes)."""
    for part in full.split(".")[1:]:
        if part in STORE_BYTES:
            return STORE_BYTES[part]
    return 4


def inner_loops(instrs, keep=None) -> list[dict]:
    """The innermost loops (among those whose opcode counts satisfy
    ``keep``, if given), each with its start, length, opcode families and
    the bytes its shared (``sts_bytes``) and global (``stg_bytes``) stores
    write an iteration."""
    def body(t, a):
        return [x for x in instrs if t <= x[0] <= a]

    loops = [(t, a) for a, _, t, _ in instrs if t is not None and t <= a]
    if keep is not None:
        loops = [lp for lp in loops if keep(collections.Counter(
            x[1] for x in body(*lp)))]
    inner = [(t, a) for t, a in loops
             if not any(t <= t2 and a2 <= a and (t2, a2) != (t, a)
                        for t2, a2 in loops)]
    out = []
    for t, a in sorted(inner):
        ins = body(t, a)
        ops = collections.Counter(x[1] for x in ins)
        out.append({"start": t, "length": sum(ops.values()) - ops["NOP"],
                    **{f: sum(ops[o] for o in names)
                       for f, names in LOOP_FAMILIES.items()},
                    "fmul": ops["FMUL"], "fadd": ops["FADD"],
                    "fmnmx": ops["FMNMX"],
                    "sts_bytes": sum(stored(x[3]) for x in ins
                                     if x[1] == "STS"),
                    "stg_bytes": sum(stored(x[3]) for x in ins
                                     if x[1] == "STG")})
    return out


def stage_loops(instrs) -> list[dict]:
    """The innermost loops that store to shared memory and read it: the
    stage walks, with their steps (STS) and instructions per output
    byte."""
    return [{**lp, "steps": lp["sts"],
             "per_output_byte": lp["length"] / lp["sts_bytes"]}
            for lp in inner_loops(instrs, lambda c: c["STS"] and c["LDS"])]


def demangle(names) -> dict:
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True,
                             timeout=60).stdout.split("\n")
    except OSError:
        out = list(names)
    return dict(zip(names, out))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chain", default=",".join(CHAIN_VARIANTS))
    ap.add_argument("--stream", default=",".join(STREAM_VARIANTS))
    ap.add_argument("--f32", default=",".join(F32_VARIANTS))
    ap.add_argument("--fchain", default=",".join(F32_CHAIN_VARIANTS))
    ap.add_argument("--pipe", default=",".join(PIPE_VARIANTS))
    ap.add_argument("--launches", type=int, default=30)
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chain_lab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    chain_names = [n for n in args.chain.split(",") if n]
    stream_names = [n for n in args.stream.split(",") if n]
    f32_names = [n for n in args.f32.split(",") if n]
    fchain_names = [n for n in args.fchain.split(",") if n]
    pipe_names = [n for n in args.pipe.split(",") if n]
    with open(STREAM_SOURCE) as f:
        stream_text = f.read()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        jobs = [pool.submit(build_variants, chain_names, CHAIN_VARIANTS,
                            "chain.cu", OUT),
                pool.submit(build_variants, stream_names, STREAM_VARIANTS,
                            "chain.cu", OUT, "\n" + stream_text),
                pool.submit(build_variants, f32_names, F32_VARIANTS,
                            "f32.cu", OUT),
                pool.submit(build_variants, fchain_names, F32_CHAIN_VARIANTS,
                            "chain.cu", os.path.join(OUT, "fchain")),
                pool.submit(build_variants, pipe_names, PIPE_VARIANTS,
                            "pipeline.cu", OUT)]
        (built_chain, built_stream, built_f32, built_fchain,
         built_pipe) = (j.result() for j in jobs)
    img, label = resolve_image()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    result = {"image": label, "nvidia_smi": smi, "launches": args.launches,
              "chain": {}, "stream": {}, "f32": {}, "fchain": {},
              "pipe": {}}
    print(f"{label} | {smi} | {args.launches} launches | µs warm / cold")

    cases = chain_cases(img)
    for name in stream_names:
        lib, log = built_stream[name]
        raw = ctypes.CDLL(lib).dip_chain_u8_stream
        raw.argtypes = [ctypes.c_int, *build.SIGNATURES["dip_chain_u8"]]
        raw.restype = ctypes.c_int
        row = {"tuning": {**tuning(stream_text, STREAM_KNOBS),
                          **STREAM_VARIANTS[name]},
               "ptxas": ptxas(log), "chains": {}}
        for cname, (planar, cargs, plain, _) in cases.items():
            r = timed_case(lambda *a, w=STREAM_WHICH[cname]: raw(w, *a),
                           planar, cargs, plain, args.launches, flush)
            row["chains"][cname] = r
            print(f"  stream {name:15s} {cname:3s} "
                  f"{'equal' if r['equal'] else 'DIFFERS'} warm "
                  f"{r['warm_us']:7.2f} cold {r['cold_us']:7.2f}")
        if args.sass:
            row["sass"] = stream_sass(lib, name)
        result["stream"][name] = row
    for name in chain_names:
        lib, log = built_chain[name]
        fn = bind(lib, "dip_chain_u8")
        row = {"tuning": {**tuning(source("chain.cu"), CHAIN_KNOBS),
                          **CHAIN_VARIANTS[name]},
               "ptxas": ptxas(log), "chains": {}}
        for cname, (planar, cargs, plain, _) in cases.items():
            r = timed_case(fn, planar, cargs, plain, args.launches, flush)
            row["chains"][cname] = r
            print(f"  chain {name:16s} {cname:3s} "
                  f"{'equal' if r['equal'] else 'DIFFERS'} warm "
                  f"{r['warm_us']:7.2f} cold {r['cold_us']:7.2f}")
        if args.sass:
            row["sass"] = chain_sass(lib, name)
        result["chain"][name] = row

    planar = to_planar_padded_f32(img, make_layout(*img.shape[:2])).cuda()
    c, hp, pitch = planar.shape
    bodies = {b: (entry, extra, plain(planar))
              for b, (entry, extra, plain) in f32_bodies().items()}
    for name in f32_names:
        lib, log = built_f32[name]
        values = {**tuning(source("f32.cu"), F32_KNOBS),
                  **F32_VARIANTS[name]}
        row = {"tuning": values, "ptxas": ptxas(log), "bodies": {}}
        for body, (entry, extra, plain) in bodies.items():
            r = timed_case(bind(lib, entry), planar, (c, hp, pitch, *extra),
                           plain, args.launches, flush)
            row["bodies"][body] = r
            print(f"  f32   {name:16s} {body:16s} "
                  f"{'equal' if r['equal'] else 'DIFFERS'} warm "
                  f"{r['warm_us']:7.2f} cold {r['cold_us']:7.2f}")
        if args.sass:
            per = 2 * values["kF32StripRows"] * 4 * values["kF32Vecs"]
            row["sass"] = {}
            for kernel, cnt in sass_counts(lib).items():
                if "window_f32_strip" not in kernel:
                    continue
                short = kernel.split("(anonymous namespace)::")[-1]
                row["sass"][short] = {"total": cnt["total"],
                                      "per_output": cnt["total"] / per}
                print(f"  f32   {name:16s} SASS {short[:50]:50s} "
                      f"{cnt['total']:6d} instr, {cnt['total'] / per:6.2f} "
                      f"per output")
        result["f32"][name] = row

    fcases = chain_cases_f32(img) if fchain_names else {}
    for name in fchain_names:
        lib, log = built_fchain[name]
        fn = bind(lib, "dip_chain_f32")
        row = {"tuning": {**knobs(source("chain.cu"), F32_CHAIN_KNOBS),
                          **F32_CHAIN_VARIANTS[name]},
               "ptxas": ptxas(log), "chains": {}}
        for cname, (planar, cargs, plain, _) in fcases.items():
            r = timed_case(fn, planar, cargs, plain, args.launches, flush)
            row["chains"][cname] = r
            print(f"  fchain {name:15s} {cname:3s} "
                  f"{'equal' if r['equal'] else 'DIFFERS'} warm "
                  f"{r['warm_us']:7.2f} cold {r['cold_us']:7.2f}")
        if args.sass:
            row["sass"] = chain_f32_sass(lib, name)
        result["fchain"][name] = row
    pcases = pipe_cases(img) if pipe_names else {}
    for name in pipe_names:
        lib, log = built_pipe[name]
        fn = bind(lib, "dip_pipeline_u8")
        values = {**knobs(source("pipeline.cu"), (*PIPE_KNOBS, "kTileH")),
                  **PIPE_VARIANTS[name]}
        row = {"tuning": values, "ptxas": ptxas(log), "chains": {}}
        for b, (stack, pargs, plain) in pcases.items():
            r = timed_case(fn, stack, pargs, plain, args.launches, flush)
            row["chains"][f"B={b}"] = r
            print(f"  pipe   {name:15s} B={b} "
                  f"{'equal' if r['equal'] else 'DIFFERS'} warm "
                  f"{r['warm_us']:7.2f} cold {r['cold_us']:7.2f} "
                  f"({r['warm_us'] / b:7.2f} an image warm)")
        if args.sass:
            row["sass"] = pipe_sass(lib, name, values)
        result["pipe"][name] = row
    print(smi)
    print(json.dumps(result))
    bad = [(v, k) for part in ("chain", "stream", "f32", "fchain", "pipe")
           for v, r in result[part].items()
           for k, x in r.get("chains", r.get("bodies", {})).items()
           if not x["equal"]]
    return 1 if bad else 0


def ptxas(log: str) -> list[str]:
    return sorted({ln.strip() for ln in log.splitlines()
                   if "registers" in ln or "spill" in ln})


def kernel_label(kernel: str) -> str:
    """A demangled kernel name without namespaces, return type and
    arguments: ``chain_u8<true>``, ``chain_u8_stream<StreamC2, true>``."""
    name = kernel.replace("(anonymous namespace)::", "")
    return name.split("(", 1)[0].removeprefix("void ")


def chain_sass(lib: str, variant: str) -> dict:
    """Each chain_u8 kernel's total SASS and its stage loops."""
    lines = sass_lines(lib)
    names = demangle(list(lines))
    out = {}
    for mangled, instrs in lines.items():
        kernel = names[mangled]
        if "chain_u8" not in kernel:
            continue
        short = kernel_label(kernel)
        loops = stage_loops(instrs)
        out[short] = {"total": len(instrs), "loops": loops}
        print(f"  chain {variant:16s} SASS {short[:40]:40s} {len(instrs):6d} "
              f"instr, {len(loops)} stage loops")
        for lp in loops:
            print(f"      loop @{lp['start']:#07x}: {lp['length']:4d} instr, "
                  f"{lp['steps']} steps, {lp['per_output_byte']:6.2f} per "
                  f"output byte | " + " ".join(
                      f"{f} {lp[f]}" for f in LOOP_FAMILIES if lp[f]))
    return out


# The windowed stages of each chain, by the multiplies an output of their
# walk (a separated pair run as one walk makes 2 N; "min": a min stage),
# and whether a point run follows the stage (the walk's longer copy).
F32_CHAIN_STAGES = {"C1": [(25, True), (9, False)],
                    "C2": [("min", False), (9, False)],
                    "C3": [(10, False), ("min", False)],
                    "C4": [(25, False)] * 4}
F32_CHAIN_STAGES_UNPAIRED = {**F32_CHAIN_STAGES,
                             "C3": [(5, False), (5, False), ("min", False)]}


def chain_f32_sass(lib: str, variant: str) -> dict:
    """chain_f32's stage walks: the innermost loops that read shared
    memory and store what they compute, to the other tile buffer or (the
    chain's last stage) to the output planes, and load nothing from global
    memory; each with its instructions per output (float), labelled by its
    multiplies an output; and per chain the sum over its windowed stages,
    each the shortest loop of its label and destination, or the longest
    where a point run follows the stage. (The first design stored every
    stage to shared memory and had one walk a label.)"""
    lines = sass_lines(lib)
    names = demangle(list(lines))
    out = {}
    for mangled, instrs in lines.items():
        kernel = names[mangled]
        if "chain_f32" not in kernel and "chain_kernel" not in kernel:
            continue
        short = kernel_label(kernel)
        planes = 3 if "true>" in short else 1
        loops = []
        for lp in inner_loops(instrs, lambda c: c["LDS"] and (
                c["STS"] or c["STG"]) and not c["LDG"] and not c["LDGSTS"]):
            to_tile = lp["sts_bytes"] > 0
            outputs = (lp["sts_bytes"] if to_tile
                       else lp["stg_bytes"] / planes) / 4
            taps = round(lp["fmul"] / outputs)
            loops.append({**lp, "outputs": outputs, "to_tile": to_tile,
                          "per_output": lp["length"] / outputs,
                          "label": taps if taps else "min"})
        by = collections.defaultdict(list)
        for lp in loops:
            by[(lp["label"], lp["to_tile"])].append(lp["per_output"])
        # The first design stores every stage to the tile.
        last_to_tile = not any(not lp["to_tile"] for lp in loops)
        sums = {}
        for cname in F32_CHAIN_STAGES:
            for stages in (F32_CHAIN_STAGES[cname],
                           F32_CHAIN_STAGES_UNPAIRED[cname]):
                keys = [((st, k < len(stages) - 1 or last_to_tile), post)
                        for k, (st, post) in enumerate(stages)]
                if all(key in by for key, _ in keys):
                    sums[cname] = sum((max if post else min)(by[key])
                                      for key, post in keys)
                    break
        out[short] = {"total": len(instrs), "loops": loops,
                      "chain_sums": sums}
        print(f"  fchain {variant:15s} SASS {short[:40]:40s} "
              f"{len(instrs):6d} instr, {len(loops)} stage loops; per output"
              f" over the stage walks: " + ", ".join(
                  f"{c} {v:.1f}" for c, v in sums.items()))
        for lp in loops:
            print(f"      loop @{lp['start']:#07x} ({lp['label']}): "
                  f"{lp['length']:4d} instr, {lp['outputs']:g} outputs, "
                  f"{lp['per_output']:6.2f} per output | " + " ".join(
                      f"{f} {lp[f]}" for f in (*LOOP_FAMILIES, "fmul",
                                               "fadd", "fmnmx") if lp[f]))
    return out


def pipe_sass(lib: str, variant: str, values: dict) -> dict:
    """pipeline_u8's loops, each with its instructions per byte it stores
    (a global store counted once for its three planes), and the kernel's
    instructions per output byte: for the shared-memory tile design (kTileH in
    the source) each phase's loop weighted by the bytes that phase makes
    per output byte; for the strip walk, unrolled whole, the kernel's
    instructions over twice a walk's output bytes (it holds two walks,
    interior and checked, and a warp runs one)."""
    lines = sass_lines(lib)
    names = demangle(list(lines))
    out = {}
    for mangled, instrs in lines.items():
        kernel = names[mangled]
        if "pipeline_u8" not in kernel:
            continue
        loops = inner_loops(instrs)
        for lp in loops:
            made = lp["sts_bytes"] or lp["stg_bytes"] / 3
            lp["per_byte_made"] = lp["length"] / made if made else None
        if "kTileH" in values:
            # mask bytes (th + 4) x (tw + 8), eroded (th + 2) x (tw + 2),
            # outputs th x tw a tile
            th, tw = values["kTileH"], values["kTileW"]
            weights = [(th + 4) * (tw + 8) / (th * tw),
                       (th + 2) * (tw + 2) / (th * tw), 1.0]
            made = [lp for lp in loops if lp["per_byte_made"]]
            per = sum(w * lp["per_byte_made"] for w, lp in zip(weights, made))
        else:
            # The strip walk is unrolled whole: two walks (interior strips
            # and checked ones) of nearly the same length, a warp runs one.
            per = len(instrs) / (2 * values["kPipeRows"] * 4
                                 * values["kPipeWords"])
        ops = collections.Counter(x[1] for x in instrs if x[1] != "NOP")
        top = ops.most_common(14)
        out[kernel_label(kernel)] = {"total": len(instrs), "loops": loops,
                                     "per_output_byte": per, "top": top}
        print(f"  pipe   {variant:15s} SASS {len(instrs):6d} instr, "
              f"{len(loops)} loops, {per:6.2f} per output byte | "
              + " ".join(f"{op} {n}" for op, n in top))
        for lp in loops:
            print(f"      loop @{lp['start']:#07x}: {lp['length']:4d} instr"
                  + (f", {lp['per_byte_made']:6.2f} per byte made"
                     if lp["per_byte_made"] else "") + " | " + " ".join(
                      f"{f} {lp[f]}" for f in LOOP_FAMILIES if lp[f]))
    return out


def stream_sass(lib: str, variant: str) -> dict:
    """Each chain_u8_stream kernel's total SASS and its walk: the longest
    innermost loop that stores to global memory, whose steps each store
    one word (three, one a plane, for a gray-first chain)."""
    lines = sass_lines(lib)
    names = demangle(list(lines))
    out = {}
    for mangled, instrs in lines.items():
        kernel = names[mangled]
        if "chain_u8_stream" not in kernel:
            continue
        short = kernel_label(kernel)
        walks = [lp for lp in inner_loops(instrs) if lp["stg"]]
        row = {"total": len(instrs)}
        if walks:
            lp = max(walks, key=lambda x: x["length"])
            steps = lp["stg"] // (3 if "true>" in short else 1)
            row["walk"] = {**lp, "steps": steps,
                           "per_output_byte": lp["length"] / (4 * steps)}
        out[short] = row
        walk = row.get("walk")
        print(f"  stream {variant:15s} SASS {short[:40]:40s} "
              f"{len(instrs):6d} instr" + (
                  f", walk {walk['length']} instr, {walk['steps']} steps, "
                  f"{walk['per_output_byte']:6.2f} per output byte | " +
                  " ".join(f"{f} {walk[f]}" for f in LOOP_FAMILIES
                           if walk[f]) if walk else ""))
    return out


if __name__ == "__main__":
    sys.exit(main())
