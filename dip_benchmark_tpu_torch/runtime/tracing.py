"""The port's spans and counters: where the host's time goes, by layer.

A span is a named stretch of host time at a layer boundary of the port
(``with tracing.span("bake"): ...``, or ``tracing.call("sync", fn,
arg)``), a counter a named integer (``tracing.count("images", b)``).
Both record while ``enable()`` is in force or while a ``torch.profiler``
profile is active. Otherwise ``span`` reads this module's state, returns
one shared null context and reads no clock, ``call`` only calls, and
``count`` does nothing; the sites a sync round passes test the two flags
inline first (``enabled`` below).

A recording span keeps, per name, its calls, its total and its self
nanoseconds (``time.perf_counter_ns``); self is the span's time less the
intervals its child spans cover, the spans of one thread nesting on a
per-thread stack. Only the sums are kept, never a list of calls. Under an
active profiler each span also opens the profiler annotation
``dip.<name>``, so the spans sit in the Chrome trace on the trace's clock,
nested as they nest, beside the CUDA runtime calls and the kernels. The
span's clock reads lie inside its annotation, and the interval a child
covers in its parent includes the child's annotation, so the
annotation's own cost is in no span's self time.

``snapshot()`` holds the latest recording period. A period starts where
recording begins after a stretch without it: at ``enable()``, or at the
first ``span``, ``call`` or ``count`` that finds a profiler active after
one of them found none. Its start clears the last period's sums.

    from dip_benchmark_tpu_torch.runtime import tracing
    tracing.enable()
    ...                                  # the rounds to split
    tracing.disable()
    snap = tracing.snapshot()
    calls, total_ns, self_ns = snap.spans["launch"]
    images = snap.counters["images"]
"""

from __future__ import annotations

import threading
import time
from types import MappingProxyType
from typing import Mapping, NamedTuple

import torch
import torch.autograd.profiler as profiler

PREFIX = "dip."

# The span clock, in ns; a module attribute so that tests can inject one.
clock = time.perf_counter_ns

# The profiler annotation: a C context manager, several times cheaper than
# record_function's dispatcher call (which records a user_annotation);
# the trace holds it as a cpu_op.
_annotation = torch._C._profiler._RecordFunctionFast

# enable() in force. A site that a sync round passes tests ``enabled or
# profiler._is_profiler_enabled`` (torch's flag of an active profiler)
# inline before it records: off, it then costs two reads, where a call
# costs a Python frame (0.12 µs or more a site in a round on the H100's
# host).
enabled = False
_profiled = False   # spans found a profiler active, with enable() off
_spans: dict[str, list[int]] = {}   # name -> [calls, total_ns, self_ns]
_counters: dict[str, int] = {}


class _Local(threading.local):
    def __init__(self):
        self.stack: list[_Span] = []   # the thread's open spans


_local = _Local()


class Snapshot(NamedTuple):
    """A frozen copy of one period: ``spans`` maps a name to its (calls,
    total_ns, self_ns), ``counters`` a name to its count."""
    spans: Mapping[str, tuple[int, int, int]]
    counters: Mapping[str, int]


class _Null:
    """What ``span`` returns while nothing records."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


_NULL = _Null()


def _clear() -> None:
    _spans.clear()
    _counters.clear()


def _recording() -> bool:
    """True while spans record; starts a period under a profiler that
    spans find active after they found none."""
    global _profiled
    if enabled:
        return True
    if profiler._is_profiler_enabled:
        if not _profiled:
            _profiled = True
            _clear()
        return True
    _profiled = False
    return False


class _Span:
    __slots__ = ("name", "parent", "covered", "t0", "outer0", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _local.stack
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.covered = 0
        if profiler._is_profiler_enabled:
            self.outer0 = clock()
            self.rf = _annotation(PREFIX + self.name)
            self.rf.__enter__()
        else:
            self.rf = None
        self.t0 = clock()
        return self

    def __exit__(self, *exc):
        t1 = clock()
        _local.stack.pop()
        took = t1 - self.t0
        covered = took
        if self.rf is not None:
            self.rf.__exit__(*exc)
            covered = clock() - self.outer0
        if self.parent is not None:
            self.parent.covered += covered
        agg = _spans.get(self.name)
        if agg is None:
            agg = _spans[self.name] = [0, 0, 0]
        agg[0] += 1
        agg[1] += took
        agg[2] += took - self.covered
        return None


def span(name: str):
    """A context manager that times its block as span ``name`` while
    recording, and the shared null context otherwise."""
    if enabled or _profiled or profiler._is_profiler_enabled:
        if _recording():
            return _Span(name)
    return _NULL


def call(name: str, fn, arg):
    """``fn(arg)``, timed as span ``name`` while recording. The form of the
    spans a session round passes: off, it costs one call and the reads of
    ``span``, without a with statement's own cost or an argument tuple's
    (one argument, so the call needs no ``*args``)."""
    if enabled or _profiled or profiler._is_profiler_enabled:
        if _recording():
            with _Span(name):
                return fn(arg)
    return fn(arg)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while recording."""
    if enabled or _profiled or profiler._is_profiler_enabled:
        if _recording():
            _counters[name] = _counters.get(name, 0) + n


def enable() -> None:
    """Record from now on, in a new period, until ``disable()``."""
    global enabled
    _clear()
    enabled = True


def disable() -> None:
    """Stop recording, unless a profiler is active: then its spans go on
    into the same period."""
    global enabled, _profiled
    enabled = False
    _profiled = bool(profiler._is_profiler_enabled)


def reset() -> None:
    """Clear the sums of the current period."""
    _clear()


def snapshot() -> Snapshot:
    """A frozen copy of the latest period's sums."""
    return Snapshot(
        MappingProxyType({k: tuple(v) for k, v in _spans.items()}),
        MappingProxyType(dict(_counters)))
