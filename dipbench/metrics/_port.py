"""What the readers of the port's own spans and counters share.

The port records its spans and counters (``dip_benchmark_tpu_torch/
runtime/tracing.py``) while a ``torch.profiler`` profile is active, so a
traced run's snapshot holds the traced sub-window, its warm-up cycle
included. A port without that module has no spans: its readers then
find nothing and return None.
"""


def snapshot():
    """The port's spans and counters of its latest recording period, or
    None where the port has no tracer."""
    try:
        from dip_benchmark_tpu_torch.runtime import tracing
    except ImportError:
        return None
    return tracing.snapshot()


def span(snap, name: str):
    """Span ``name``'s (calls, total_ns, self_ns), or None without
    calls."""
    if snap is None:
        return None
    got = snap.spans.get(name)
    return got if got and got[0] else None


def counter(snap, name: str):
    """Counter ``name``, or None where it is 0 or absent."""
    if snap is None:
        return None
    return snap.counters.get(name) or None
