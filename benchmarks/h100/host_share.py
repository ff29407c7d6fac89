#!/usr/bin/env python3
"""Split the host share of the port's CLI rounds from one profiler trace.

    python3 benchmarks/h100/host_share.py <trace.json>

Reads the Chrome trace that ``python -m dip_benchmark_tpu_torch.cli ...
--profile DIR`` writes (``DIR/trace.json``: CPU and CUDA activity and the
port's spans, the ``dip.*`` annotations of ``runtime/tracing.py``). A
timed round of the kernel path is an ``op`` span (the op table's
wrapper, around its ``alloc`` and ``launch`` spans) and the ``sync`` span
that ends it. Every round that launched a kernel is split into:

- kernel: the device time of the kernels it launched (CUDA activity; a
  kernel belongs to the round in which its launch call ran, matched by
  the trace's correlation id, so the card's clock is never compared with
  the host's to place it);
- harness: from the end of one round's ``sync`` to the next round's
  ``op`` in the same op's loop (``utils/timing.measure_time``);
- wrapper: the ``op`` span without its ``alloc`` and ``launch`` spans
  (the checks, the dispatch, the argument packing);
- launch: the ``launch`` spans (the library's load, the device context,
  the stream lookup, the ctypes call and its launch);
- alloc: the ``alloc`` spans (the output);
- sync wait: the part of the ``sync`` span spent while the round's
  kernel still ran; sync own: the rest of it, after the kernel ended;
- idle: 1 - kernel / round.

Every part is a median over the rounds of one kernel; the spans' own
annotations lie inside them, so read the parts as an upper bound on an
unprofiled round's. ``idle_by_span`` cuts the device's idle time of each
round, from its ``op`` to the next round's (every device interval
clipped to it, their union the busy time), by the innermost port span
open on the host meanwhile, "outside the port" where none is: a mean a
round, each kernel's parts summing to its idle time. It compares the
card's clock with the host's, as the sync columns do: ``clock_skew``
says how far the trace's conversion is off (a kernel cannot start before
its launch call).
"""

from __future__ import annotations

import bisect
import json
import re
import statistics
import sys

PREFIX = "dip."
OUTSIDE = "outside the port"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


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


def _events(trace: dict) -> list[dict]:
    return [e for e in trace["traceEvents"] if e.get("ph") == "X"]


def _launch_times(events) -> dict:
    """The host timestamp of every CUDA runtime or driver call by
    correlation id."""
    return {e["args"]["correlation"]: e["ts"] for e in events
            if e.get("cat") in LAUNCH_CATS
            and "correlation" in e.get("args", {})}


class Spans:
    """The port's spans of a trace, sorted by start, with their depth
    (0 for a span in no other)."""

    def __init__(self, events):
        found = sorted(((e["ts"], e["ts"] + e["dur"], e["name"][len(PREFIX):])
                        for e in events
                        if e.get("name", "").startswith(PREFIX)),
                       key=lambda s: (s[0], -s[1]))
        self.spans, ends = [], []
        for ts, end, name in found:
            while ends and ends[-1] <= ts:
                ends.pop()
            self.spans.append((ts, end, name, len(ends)))
            ends.append(end)
        self.starts = [s[0] for s in self.spans]
        self.longest = max((s[1] - s[0] for s in self.spans), default=0.0)

    def roots(self, name: str) -> list[tuple]:
        return [s for s in self.spans if s[2] == name and s[3] == 0]

    def inside(self, t0: float, t1: float, name: str) -> list[tuple]:
        i = bisect.bisect_left(self.starts, t0)
        j = bisect.bisect_right(self.starts, t1)
        return [s for s in self.spans[i:j] if s[2] == name and s[1] <= t1]

    def cut(self, g0: float, g1: float, into: dict) -> None:
        """Add [g0, g1] to ``into`` by the innermost span open along it."""
        i = bisect.bisect_left(self.starts, g0 - self.longest)
        j = bisect.bisect_right(self.starts, g1)
        open_ = [s for s in self.spans[i:j] if s[1] > g0]
        cuts = sorted({g0, g1} | {t for s in open_ for t in s[:2]
                                   if g0 < t < g1})
        for a, b in zip(cuts, cuts[1:]):
            mid = (a + b) / 2
            holding = [s for s in open_ if s[0] <= mid < s[1]]
            label = (max(holding, key=lambda s: s[3])[2] if holding
                     else OUTSIDE)
            into[label] = into.get(label, 0.0) + (b - a)


def _merged(intervals) -> list[list[float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def rounds(trace: dict) -> list[dict]:
    """One dict a round that launched kernels: its kernel names and the
    parts above in µs (harness, round and idle_by_span None for the last
    round of a loop)."""
    events = _events(trace)
    spans = Spans(events)
    ops, syncs = spans.roots("op"), spans.roots("sync")
    sync_starts = [s[0] for s in syncs]
    launched = _launch_times(events)
    # Kernels by the host time of their launch call.
    gpu = sorted(((launched[e["args"]["correlation"]], e) for e in events
                  if e.get("cat") == "kernel"
                  and e["args"].get("correlation") in launched),
                 key=lambda g: g[0])
    gpu_at = [g[0] for g in gpu]
    device = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") in DEVICE_CATS)
    out = []
    for k, op in enumerate(ops):
        t0 = op[0]
        nxt = ops[k + 1][0] if k + 1 < len(ops) else float("inf")
        i = bisect.bisect_left(sync_starts, op[1])
        if i == len(syncs) or syncs[i][0] >= nxt:
            continue
        sync = syncs[i]
        t1 = sync[1]
        kern = [e for _, e in gpu[bisect.bisect_left(gpu_at, t0):
                                  bisect.bisect_right(gpu_at, t1)]]
        if not kern:
            continue
        kernel_end = max(e["ts"] + e["dur"] for e in kern)
        wait = max(0.0, min(kernel_end, t1) - sync[0])
        alloc = sum(s[1] - s[0] for s in spans.inside(op[0], op[1], "alloc"))
        launch = sum(s[1] - s[0]
                     for s in spans.inside(op[0], op[1], "launch"))
        out.append({
            "kernel": ",".join(sorted({kernel_name(e["name"])
                                       for e in kern})),
            "ts": t0, "end": t1,
            "round": None, "harness": None, "busy": None,
            "idle_by_span": None,
            "device": sum(e["dur"] for e in kern),
            "wrapper": op[1] - op[0] - alloc - launch,
            "launch": launch, "alloc": alloc,
            "sync_wait": wait, "sync_own": sync[1] - sync[0] - wait})
    starts = [d[0] for d in device]
    longest = max((b - a for a, b in device), default=0.0)
    for a, b in zip(out, out[1:]):
        if a["kernel"] != b["kernel"]:
            continue
        a["round"] = b["ts"] - a["ts"]
        a["harness"] = b["ts"] - a["end"]
        lo = bisect.bisect_left(starts, a["ts"] - longest)
        hi = bisect.bisect_right(starts, b["ts"])
        busy = _merged((max(s, a["ts"]), min(e, b["ts"]))
                       for s, e in device[lo:hi]
                       if e > a["ts"] and s < b["ts"])
        a["busy"] = sum(e - s for s, e in busy)
        idle: dict[str, float] = {}
        prev = a["ts"]
        for s, e in busy + [[b["ts"], b["ts"]]]:
            if s > prev:
                spans.cut(prev, s, idle)
            prev = max(prev, e)
        a["idle_by_span"] = idle
    return out


def clock_skew(trace: dict) -> tuple[float, float, float]:
    """Min, median and max µs from each kernel's launch call to the
    kernel's start, as the trace's clocks put them; a negative value is
    the conversion's error, not a time."""
    events = _events(trace)
    launched = _launch_times(events)
    gaps = sorted(e["ts"] - launched[e["args"]["correlation"]]
                  for e in events if e.get("cat") == "kernel"
                  and e["args"].get("correlation") in launched)
    return gaps[0], statistics.median(gaps), gaps[-1]


PARTS = ("round", "device", "harness", "wrapper", "launch", "alloc",
         "sync_wait", "sync_own")
SPAN_COLUMNS = ("op", "alloc", "launch", "sync", OUTSIDE)


def idle_by_span(rows: list[dict]) -> dict[str, float]:
    """The mean idle µs a round of ``rows`` by the span that held the
    host."""
    out: dict[str, float] = {}
    for r in rows:
        for k, v in r["idle_by_span"].items():
            out[k] = out.get(k, 0.0) + v / len(rows)
    return out


def split(path: str) -> list[dict]:
    """Per kernel, the median of each part over its rounds that have a
    next round in the same loop, the idle share of the round, the mean
    idle µs of a round (the round less the union of the device's
    intervals in it, ``idle_us``) and its split by span
    (``idle_by_span``)."""
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
        out.append({"kernel": name, "rounds": len(rs), **med,
                    "idle_us": statistics.mean(r["round"] - r["busy"]
                                               for r in rs),
                    "idle_by_span": idle_by_span(rs)})
    return out


def main(argv: list[str]) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    rows = split(argv[0])
    with open(argv[0]) as f:
        skew = clock_skew(json.load(f))
    print("kernel start - its launch call, trace clocks (min, median, "
          "max µs): " + ", ".join(f"{v:.1f}" for v in skew))
    print("| kernel | rounds | round µs | kernel µs | harness | wrapper | "
          "launch | alloc | sync wait | sync own | idle |")
    for r in rows:
        print(f"| {r['kernel']} | {r['rounds']} | "
              + " | ".join(f"{r[p]:.1f}" for p in PARTS)
              + f" | {100 * r['idle']:.0f} % |")
    print("idle µs a round by the port's span open on the host (means; "
          "off by up to the clock skew above):")
    print("| kernel | idle | " + " | ".join(SPAN_COLUMNS) + " |")
    for r in rows:
        by = r["idle_by_span"]
        print(f"| {r['kernel']} | {r['idle_us']:.1f} | "
              + " | ".join(f"{by.get(c, 0.0):.1f}" for c in SPAN_COLUMNS)
              + " |")
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
