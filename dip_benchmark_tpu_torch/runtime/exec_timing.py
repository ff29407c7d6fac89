"""Device execution time per application: the slope of T(K) over K.

The port of ``dip_benchmark_tpu/runtime/exec_timing.py``
(``execution_time``). The idea is the reference's: time runs of K chained
applications ``y = op(y)`` and take the slope over K, so whatever a run
costs once (the launch of the run, the wait for it) drops out. What is
not ported are the relay rig's workarounds: interleaved pairs,
``RESOLVE_FLOOR_S`` and the forced one-element read back.

On the card, the K applications are captured once into one
``torch.cuda.CUDAGraph`` (``GraphCache``), which is replayed once untimed
and then timed with CUDA events, ``samples`` replays of each K, the K
values in turn within a sample, queued behind an untimed replay so that
the card, not the host, sets the pace: a is then the device's fixed cost
of a replay. On the CPU, K plain applications are
timed with ``time.perf_counter``. Either way, T(K) = a + b K is fitted by
least squares over every sample: b is the time of one application, a the
fixed cost of a timed run. The spread of b is the least and the most
slope fitted to one sample's points, beside the fit's standard error. A
slope is never clamped: a negative one, or a spread that reaches 0, is
reported as it is and marked (``ExecTime.mark``).

Chained values drift from real op outputs (a windowed op reads its own
halo K times); only the launches matter for timing. What a capture
launches is held to the op itself: each graph's output, replayed once,
must equal K direct applications (tolerance 0) before it is timed.

Whether the chain runs from L2 is a matter of size: an application reads
its input and writes its output, and when both fit the card's L2 the next
application finds its input there ("L2-warm"); otherwise "L2-cold".

An op's input may also be a tuple of tensors, a sharded value
(``parallel/``): one application is then the whole sharded op, every
shard's refresh and launch, captured into one graph. Its tensors must
all be on one device.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Any, Callable

import torch

KS = (10, 40, 160)
SAMPLES = 5


@dataclass(frozen=True)
class ExecTime:
    """Seconds per application (``per_app_s``, the slope b) with the fit's
    intercept ``fixed_s`` (a), the least and most slope fitted to one
    sample, the slope's standard error, the K values, the sample count
    and where the working set lives ("L2-warm", "L2-cold" or "host")."""
    per_app_s: float
    fixed_s: float
    slope_min_s: float
    slope_max_s: float
    stderr_s: float
    ks: tuple[int, ...]
    samples: int
    where: str

    @property
    def mark(self) -> str:
        """Empty for a slope that every sample resolves above 0, else
        "NEGATIVE" or "UNRESOLVED"."""
        if self.per_app_s < 0:
            return "NEGATIVE"
        return "" if self.slope_min_s > 0 else "UNRESOLVED"


def fit_line(points: list[tuple[float, float]]) -> tuple[float, float, float]:
    """(a, b, standard error of b) of the least-squares line t = a + b k
    through ``points`` (k, t); needs at least three points and two ks."""
    n = len(points)
    ks = {k for k, _ in points}
    if n < 3 or len(ks) < 2:
        raise ValueError("a slope needs at least three points and two "
                         "different K")
    mk = sum(k for k, _ in points) / n
    mt = sum(t for _, t in points) / n
    sxx = sum((k - mk) ** 2 for k, _ in points)
    b = sum((k - mk) * (t - mt) for k, t in points) / sxx
    a = mt - b * mk
    resid = sum((t - a - b * k) ** 2 for k, t in points)
    return a, b, math.sqrt(resid / (n - 2) / sxx)


def fit_times(ks, times: list[list[float]], where: str) -> ExecTime:
    """The ExecTime of ``times[sample][i]``, the seconds of a run of
    ``ks[i]`` applications."""
    points = [(k, t) for sample in times for k, t in zip(ks, sample)]
    a, b, stderr = fit_line(points)
    if len(ks) > 2:
        slopes = [fit_line(list(zip(ks, sample)))[1] for sample in times]
    else:
        slopes = [b]
    return ExecTime(b, a, min(slopes), max(slopes), stderr, tuple(ks),
                    len(times), where)


def tensors(x) -> tuple[torch.Tensor, ...]:
    """An op's input or output as a tuple of tensors: ``x`` itself when it
    is a tuple (a sharded value), else ``(x,)``."""
    return x if isinstance(x, tuple) else (x,)


def same(a, b) -> bool:
    """True when two inputs or outputs hold equal tensors (tolerance 0)."""
    ta, tb = tensors(a), tensors(b)
    return len(ta) == len(tb) and all(torch.equal(p, q)
                                      for p, q in zip(ta, tb))


def shapes(x) -> tuple:
    """The (shape, dtype, device) of each tensor of ``x``."""
    return tuple((tuple(t.shape), t.dtype, t.device) for t in tensors(x))


def l2_residency(x) -> str:
    """Return "L2-warm" when an application's input and output together
    fit the L2 of ``x``'s card, else "L2-cold"."""
    parts = tensors(x)
    l2 = torch.cuda.get_device_properties(parts[0].device).L2_cache_size
    size = sum(t.numel() * t.element_size() for t in parts)
    return "L2-warm" if 2 * size <= l2 else "L2-cold"


def chain_direct(op: Callable, x: torch.Tensor, k: int) -> torch.Tensor:
    """``op`` applied ``k`` times, ``y = op(y)``."""
    for _ in range(k):
        x = op(x)
    return x


class GraphCache:
    """CUDA graphs of K chained applications of an op, keyed by (op name,
    input shapes, dtypes, K). Every graph of one input shape and dtype
    reads one static input (a tensor, or a tuple of them); ``replay``
    copies the caller's input into it when it is another tensor, or was
    written since."""

    def __init__(self):
        self._graphs: dict[tuple, tuple[torch.cuda.CUDAGraph, Any]] = {}
        self._inputs: dict[tuple, list] = {}

    def _static_input(self, x):
        parts = tensors(x)
        versions = tuple(t._version for t in parts)
        key = shapes(x)
        entry = self._inputs.get(key)
        if entry is None:
            entry = self._inputs[key] = [tuple(t.clone() for t in parts),
                                         parts, versions]
        elif (any(a is not b for a, b in zip(entry[1], parts))
              or entry[2] != versions):
            for static, t in zip(entry[0], parts):
                static.copy_(t)
            entry[1:] = [parts, versions]
        return entry[0] if isinstance(x, tuple) else entry[0][0]

    def get(self, name: str, op: Callable, x,
            k: int) -> tuple[torch.cuda.CUDAGraph, Any]:
        """The graph of ``k`` applications of ``op`` on ``x``'s shape and
        its output, captured at the first request. The caller has run
        ``op`` once outside capture (the kernel library is built and
        every per-op constant is on the card by then)."""
        static = self._static_input(x)
        key = (name, shapes(x), k)
        if key not in self._graphs:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = chain_direct(op, static, k)
            self._graphs[key] = (graph, out)
        return self._graphs[key]

    def replay(self, name: str, op: Callable, x, k: int):
        """Replay the ``k``-application graph on ``x``; returns its output
        (complete once the stream reaches it)."""
        graph, out = self.get(name, op, x, k)
        graph.replay()
        return out


def _host_times(op: Callable, x, ks,
                samples: int) -> list[list[float]]:
    chain_direct(op, x, 1)
    times = []
    for _ in range(samples):
        row = []
        for k in ks:
            t0 = time.perf_counter()
            chain_direct(op, x, k)
            row.append(time.perf_counter() - t0)
        times.append(row)
    return times


def _device_times(name: str, op: Callable, x, ks,
                  samples: int, graphs: GraphCache) -> list[list[float]]:
    for k in ks:
        direct = chain_direct(op, x, k)
        out = graphs.replay(name, op, x, k)
        if not same(out, direct):
            raise RuntimeError(
                f"{name}: the CUDA graph of {k} applications differs from "
                f"{k} direct calls")
    marks = [[(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in ks]
             for _ in range(samples)]
    # An untimed replay of the longest chain keeps the card busy while the
    # host queues the timed ones, so no event pair spans host work.
    graphs.get(name, op, x, max(ks))[0].replay()
    for sample in marks:
        for k, (start, end) in zip(ks, sample):
            graph, _ = graphs.get(name, op, x, k)
            start.record()
            graph.replay()
            end.record()
    torch.cuda.synchronize(tensors(x)[0].device)
    return [[1e-3 * s.elapsed_time(e) for s, e in sample]
            for sample in marks]


def execution_time(name: str, op: Callable, x, ks=KS,
                   samples: int = SAMPLES) -> ExecTime:
    """Seconds of one application of ``op`` on ``x`` (a shape-preserving
    op of a tensor or of a tuple of them), from runs of each K in ``ks``:
    CUDA graphs timed by events on the card (``name`` keys them; they are
    dropped on return), the host clock on the CPU."""
    if tensors(x)[0].device.type == "cpu":
        return fit_times(ks, _host_times(op, x, ks, samples), "host")
    times = _device_times(name, op, x, ks, samples, GraphCache())
    return fit_times(ks, times, l2_residency(x))
