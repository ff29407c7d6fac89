"""Reduce one profiler trace of a traced sub-window to what the readers need.

The benchmark marks the sub-window with a ``dipbench.window`` annotation
and each timed round inside it with ``round:<name>``, both on the host.
Device activity (kernels, copies, sets) is put in a round by its
correlation id: the id of the CUDA runtime or driver call that launched
it, whose host timestamp lies inside the round's annotation (the
arithmetic of ``benchmarks/h100/host_share.py``), so the card's clock is
never compared with the host's to place it. Device intervals are clipped
to the sub-window, and their union is the busy time. Every quantity is
a sum over the sub-window, not a median of pieces.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field

WINDOW = "dipbench.window"
ROUND = "round:"
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


def merged(intervals: list[tuple[float, float]]) -> list[list[float]]:
    """The union of the intervals as sorted disjoint [start, end]."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


@dataclass
class Round:
    """One timed round of the sub-window: its name and what the device
    did for it."""
    name: str
    kernel_us: float = 0.0
    copy_bytes: int = 0
    copy_us: float = 0.0
    busy_us: float = 0.0    # the union of its device intervals


@dataclass
class TraceSummary:
    """Sums over the sub-window, in microseconds (the trace's unit)."""
    window_us: float
    busy_us: float
    rounds: list[Round]
    device_us_by_name: dict[str, float]
    idle_us_by_span: dict[str, float] = field(default_factory=dict)

    @property
    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_us / self.window_us)

    def busy_by_kind(self) -> dict[str, float]:
        """The mean device busy time of a round of each kind (its name),
        over the traced rounds of that kind."""
        sums: dict[str, list[float]] = {}
        for r in self.rounds:
            sums.setdefault(r.name, []).append(r.busy_us)
        return {k: sum(v) / len(v) for k, v in sums.items()}

    def breakdown(self, n: int = 10) -> dict:
        """The device operations (kernels by name, copies and sets) with the
        most device time, and the idle time before the device activity of
        each round's span, by the span's name; seconds, the largest first."""
        def top(d):
            return [[k, v * 1e-6] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:n]]
        return {"device_ops": top(self.device_us_by_name),
                "idle_gaps": top(self.idle_us_by_span)}


def summarize(trace: dict) -> TraceSummary | None:
    """The summary of a Chrome trace as ``torch.profiler`` exports it, or
    None when it has no window annotation or no device activity in it."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    windows = [e for e in events if e.get("cat") == "user_annotation"
               and e.get("name") == WINDOW]
    if not windows:
        return None
    w0 = windows[0]["ts"]
    w1 = w0 + windows[0]["dur"]
    spans = sorted((e for e in events if e.get("cat") == "user_annotation"
                    and e.get("name", "").startswith(ROUND)),
                   key=lambda e: e["ts"])
    rounds = [Round(e["name"][len(ROUND):]) for e in spans]
    starts = [e["ts"] for e in spans]

    def round_of(ts: float) -> int | None:
        lo, hi = 0, len(spans)
        while lo < hi:       # the last span starting at or before ts
            mid = (lo + hi) // 2
            if starts[mid] <= ts:
                lo = mid + 1
            else:
                hi = mid
        i = lo - 1
        if i >= 0 and ts <= spans[i]["ts"] + spans[i]["dur"]:
            return i
        return None

    launched = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launched[e["args"]["correlation"]] = e["ts"]

    device = []        # (start, end, round index or None)
    by_name: dict[str, float] = {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if b <= a:
            continue
        corr = e.get("args", {}).get("correlation")
        i = round_of(launched[corr]) if corr in launched else None
        device.append((a, b, i))
        name = kernel_name(e["name"]) if e["cat"] == "kernel" else e["name"]
        by_name[name] = by_name.get(name, 0.0) + (b - a)
        if e["cat"] == "kernel":
            if i is not None:
                rounds[i].kernel_us += b - a
        elif e["cat"] == "gpu_memcpy" and i is not None:
            rounds[i].copy_bytes += int(e.get("args", {}).get("bytes", 0))
            rounds[i].copy_us += b - a
    if not device:
        return None
    per_round: dict[int, list[tuple[float, float]]] = {}
    for a, b, i in device:
        if i is not None:
            per_round.setdefault(i, []).append((a, b))
    for i, iv in per_round.items():
        rounds[i].busy_us = sum(b - a for a, b in merged(iv))
    busy = merged([(a, b) for a, b, _ in device])
    first_round = {}     # where each merged interval starts: its round
    for a, _, i in sorted(device, key=lambda d: d[0]):
        first_round.setdefault(a, i)
    idle: dict[str, float] = {}
    prev_end = w0
    for a, b in busy:
        gap = a - prev_end
        if gap > 0:
            i = first_round.get(a)
            label = rounds[i].name if i is not None else "outside rounds"
            idle[label] = idle.get(label, 0.0) + gap
        prev_end = b
    if w1 > prev_end:
        idle["after the last round"] = w1 - prev_end
    return TraceSummary(w1 - w0, sum(b - a for a, b in busy), rounds,
                        by_name, idle)


def load(path: str) -> TraceSummary | None:
    with open(path) as f:
        return summarize(json.load(f))
