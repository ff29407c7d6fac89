#!/usr/bin/env python3
"""Split the host share of the port's CLI rounds from one profiler trace.

    python3 benchmarks/h100/host_share.py <trace.json>

Reads the Chrome trace that ``python -m dip_benchmark_tpu_torch.cli ...
--profile DIR`` writes (``DIR/trace.json``: CPU and CUDA activity with the
Python calls) and splits every timed round of the kernel path, one call of
a session ``run`` closure and the harness code until the next, into:

- kernel: the device time of the kernels it launched (CUDA activity);
- harness: from the end of one ``run`` to the start of the next in the
  same op's loop (``utils/timing.measure_time``);
- wrapper: the op's Python call without its output allocation and without
  ``kernels.launch`` (the checks, the argument packing);
- launch: ``ops/kernels/__init__.py`` ``launch`` (``torch.cuda.device``,
  the stream lookup, the ctypes call and its launch);
- alloc: the ``aten::empty*`` calls inside the round (the output);
- sync wait: the part of ``torch.cuda.synchronize`` spent while the
  round's kernel still ran; sync own: the rest of it, after the kernel
  ended;
- idle: 1 - kernel / round.

Every part is a median over the rounds of one kernel. The Python tracer
adds its own cost to every Python call it records, so the Python parts
(harness, wrapper, launch) are larger than in an untraced run: read the
split as proportions, and the untraced CLI rows for the totals.
"""

from __future__ import annotations

import json
import re
import statistics
import sys

RUN = re.compile(r"session\.py\(\d+\): run$")
SYNC = re.compile(r"runtime/device\.py\(\d+\): synchronize$")
LAUNCH = re.compile(r"ops/kernels/__init__\.py\(\d+\): launch$")
ALLOC = ("aten::empty", "aten::empty_like", "aten::empty_strided")


def kernel_name(name: str) -> str:
    """A CUDA kernel's name without its return type, namespaces and
    parameter list: ``window_u8_strip<MinRect>``."""
    name = re.sub(r"^void ", "", name)
    name = name.replace("(anonymous namespace)::", "").replace("dip::", "")
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out)


def _inside(events, t0: float, t1: float):
    return [e for e in events if t0 <= e["ts"] and e["ts"] + e["dur"] <= t1]


def _top_level(events):
    """The events not nested in another of ``events`` (one thread)."""
    out, end = [], float("-inf")
    for e in sorted(events, key=lambda e: (e["ts"], -e["dur"])):
        if e["ts"] >= end:
            out.append(e)
            end = e["ts"] + e["dur"]
    return out


def rounds(trace: dict) -> list[dict]:
    """One dict a ``run`` call that launched kernels: its kernel names and
    the parts above in µs (harness None for the last round of a loop)."""
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    py = [e for e in events if e.get("cat") == "python_function"]
    runs = sorted((e for e in py if RUN.search(e["name"])),
                  key=lambda e: e["ts"])
    syncs = [e for e in py if SYNC.search(e["name"])]
    launches = [e for e in py if LAUNCH.search(e["name"])]
    cpu_ops = [e for e in events if e.get("cat") == "cpu_op"]
    gpu = [e for e in events if e.get("cat") == "kernel"]
    out = []
    for r in runs:
        t0, t1 = r["ts"], r["ts"] + r["dur"]
        kern = [k for k in gpu if t0 <= k["ts"] <= t1]
        if not kern:
            continue
        sync = max(_inside(syncs, t0, t1), key=lambda e: e["ts"])
        sync_end = sync["ts"] + sync["dur"]
        kernel_end = max(k["ts"] + k["dur"] for k in kern)
        wait = max(0.0, min(kernel_end, sync_end) - sync["ts"])
        alloc = sum(e["dur"] for e in _top_level(_inside(cpu_ops, t0, t1))
                    if e["name"] in ALLOC)
        launch = sum(e["dur"] for e in _inside(launches, t0, t1))
        out.append({
            "kernel": ",".join(sorted({kernel_name(k["name"])
                                       for k in kern})),
            "ts": t0, "end": t1,
            "round": None, "harness": None,
            "device": sum(k["dur"] for k in kern),
            "wrapper": r["dur"] - sync["dur"] - alloc - launch,
            "launch": launch, "alloc": alloc,
            "sync_wait": wait, "sync_own": sync["dur"] - wait})
    for a, b in zip(out, out[1:]):
        if a["kernel"] == b["kernel"]:
            a["round"] = b["ts"] - a["ts"]
            a["harness"] = b["ts"] - a["end"]
    return out


PARTS = ("round", "device", "harness", "wrapper", "launch", "alloc",
         "sync_wait", "sync_own")


def split(path: str) -> list[dict]:
    """Per kernel, the median of each part over its rounds that have a
    next round in the same loop, and the idle share of the round."""
    with open(path) as f:
        rows = rounds(json.load(f))
    by_kernel: dict[str, list[dict]] = {}
    for r in rows:
        if r["round"] is not None:
            by_kernel.setdefault(r["kernel"], []).append(r)
    out = []
    for name, rs in by_kernel.items():
        med = {p: statistics.median(r[p] for r in rs) for p in PARTS}
        med["idle"] = 1 - med["device"] / med["round"]
        out.append({"kernel": name, "rounds": len(rs), **med})
    return out


def main(argv: list[str]) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    rows = split(argv[0])
    print("| kernel | rounds | round µs | kernel µs | harness | wrapper | "
          "launch | alloc | sync wait | sync own | idle |")
    for r in rows:
        print(f"| {r['kernel']} | {r['rounds']} | "
              + " | ".join(f"{r[p]:.1f}" for p in PARTS)
              + f" | {100 * r['idle']:.0f} % |")
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
