"""Two-phase benchmark timer (the L3 measure_time contract, SURVEY.md §3).

The port's own copy of ``dip_benchmark_tpu/utils/timing.py``.

Reference contract [opencv/benchmark.py:26-38, sycl/benchmark.cpp:25-39]:
run once (timed — includes the first launch's set-up cost, the "once"
column), then run `rounds` times and report the mean (the "repeatedly"
column).

Thunks passed here synchronize internally (``torch.cuda.synchronize`` on
the card), so the repeated column is completed device work plus the
host's launch and sync cost, the SYCL reference's per-round `.wait()`
semantics (sycl/benchmark.cpp:32). The clock is time.perf_counter_ns, a
monotonic nanosecond clock.
"""

from __future__ import annotations

import time
from typing import Any, Callable

_clock_ns = time.perf_counter_ns


def measure_time(func: Callable[[], Any], rounds: int,
                 warmup: int = 0) -> tuple[float, float]:
    """Return (seconds_once, seconds_per_round_mean).

    warmup: untimed calls between the once phase and the timed loop, so
    the repeated column measures the steady state. The once column still
    includes the first call's set-up cost, per the reference contract."""
    t0 = _clock_ns()
    func()
    t1 = _clock_ns()

    for _ in range(warmup):
        func()

    t2 = _clock_ns()
    for _ in range(rounds):
        func()
    t3 = _clock_ns()

    return (t1 - t0) * 1e-9, (t3 - t2) * 1e-9 / max(rounds, 1)


def p95_nearest_rank(sorted_samples):
    """Nearest-rank p95: index ceil(0.95n) - 1. The naive int(0.95n) is
    one rank too high whenever 0.95n is integral — at n=20 it selects the
    MAX, reporting a single spike as the p95."""
    return sorted_samples[max(0, -(-95 * len(sorted_samples) // 100) - 1)]


def measure_time_stats(func: Callable[[], Any], rounds: int,
                       warmup: int = 0
                       ) -> tuple[float, float, dict[str, float]]:
    """Like measure_time but additionally records per-round timestamps and
    returns {min, p50, p95, max} seconds — the per-kernel latency
    distribution the reference's mean-only timer can't see (SURVEY.md §5
    tracing gap). Per-round clock reads add ~100 ns each; the mean is
    computed from the same loop so it stays comparable."""
    t0 = _clock_ns()
    func()
    t1 = _clock_ns()

    for _ in range(warmup):
        func()

    stamps = [0] * (rounds + 1)
    stamps[0] = _clock_ns()
    for i in range(rounds):
        func()
        stamps[i + 1] = _clock_ns()
    deltas = sorted((stamps[i + 1] - stamps[i]) * 1e-9
                    for i in range(rounds))
    n = max(rounds, 1)
    stats = {
        "min": deltas[0] if deltas else 0.0,
        "p50": deltas[len(deltas) // 2] if deltas else 0.0,
        "p95": p95_nearest_rank(deltas) if deltas else 0.0,
        "max": deltas[-1] if deltas else 0.0,
        # Raw sorted per-round seconds, so callers can pool distributions.
        "samples": deltas,
    }
    mean = (stamps[rounds] - stamps[0]) * 1e-9 / n
    return (t1 - t0) * 1e-9, mean, stats
