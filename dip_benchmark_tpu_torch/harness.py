"""L3 harness: the operations table and the benchmark loop.

The port's own copy of ``dip_benchmark_tpu/harness.py``. It reproduces the
reference contract [opencv/benchmark.py:41-114, sycl/benchmark.cpp:254-387]:
build a list of (description, prefix, thunk), time each with the two-phase
timer, print a markdown row, and dump each op's result image as
<prefix>-<filename> (skipping memory ops with empty prefix, the 4-of-5
consensus — the OpenCV backend's stray empty-prefix write is a known
reference bug, SURVEY.md §2.4.7).

As in the JAX package, the harness measures every op first and fetches,
saves and verifies afterwards (re-running each image op once, untimed;
the reference also treats the dump as untimed, SURVEY.md §3.2 step (c)),
and measures the ops that download to the host (``downloads=True``) last.
Rows are printed in canonical matrix order.

On top of the reference contract: programmatic results.csv writing,
per-op latency distributions (``stats``) and bit-exact output
verification against the oracle ops the caller passes.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from . import spec
from .utils import reporting
from .utils.image import save_image
from .utils.timing import measure_time, measure_time_stats


@dataclass
class Operation:
    description: str
    prefix: str
    csv_column: str
    run: Callable[[], Any]          # one timed round; must sync the device
    fetch: Callable[[], np.ndarray]  # last result as uint8 HWC (untimed)
    # Ops whose run() itself transfers device->host; measured last.
    downloads: bool = field(default=False)


class BenchmarkRunner:
    """Runs an operations table with the reference timing/reporting protocol."""

    def __init__(self, operations: list[Operation], rounds: int = 10000,
                 rounds_override: dict[str, int] | None = None,
                 stats: bool = False, warmup: int = 0):
        """rounds_override: per-CSV-column round counts (e.g. fewer rounds
        for the host-transfer ops); each row prints its own N.
        stats: also collect per-round latency distributions (min/p50/p95/max)
        into self.op_stats.
        warmup: untimed calls before each op's timed loop (capped at 1 for
        the host-transfer ops); see utils.timing.measure_time."""
        self.operations = operations
        self.rounds = rounds
        self.rounds_override = rounds_override or {}
        self.stats = stats
        self.warmup = warmup
        self.op_stats: dict[str, dict[str, float]] = {}
        self.results: list[reporting.OpResult] = []

    def run(self, filename: str | None = None, outdir: str | None = None,
            verify_against: np.ndarray | None = None,
            verify_ops: dict | None = None,
            verify_atol: int = 0) -> list[reporting.OpResult]:
        """verify_against: the input image; each image op's output is then
        held against ``verify_ops[csv_column](verify_against)`` within
        ``verify_atol``, and any difference raises AssertionError after
        every op was checked."""
        if verify_against is not None and verify_ops is None:
            raise ValueError("verify_against needs verify_ops, the oracle "
                             "ops keyed by CSV column")
        width = max(len(op.description) for op in self.operations)
        failures: list[str] = []

        # Phase 1: measure. D2H-bearing ops go last.
        order = ([op for op in self.operations if not op.downloads]
                 + [op for op in self.operations if op.downloads])
        by_id: dict[int, reporting.OpResult] = {}
        for op in order:
            n = self.rounds_override.get(op.csv_column, self.rounds)
            warm = (min(self.warmup, 1)
                    if op.csv_column in ("Upload", "Download")
                    else self.warmup)
            if self.stats:
                time_once, time_rounds, dist = measure_time_stats(
                    op.run, n, warmup=warm)
                self.op_stats[op.csv_column] = dist
            else:
                time_once, time_rounds = measure_time(op.run, n, warmup=warm)
            by_id[id(op)] = reporting.OpResult(
                op.description, op.prefix, op.csv_column,
                time_once, time_rounds, rounds=n)
        self.results = [by_id[id(op)] for op in self.operations]

        # Phase 2: report rows in canonical order, then fetch/save/verify
        # (re-running each image op once, untimed).
        for result in self.results:
            print(reporting.format_row(result, width=width))
            if self.stats:
                d = self.op_stats[result.csv_column]
                print(f"|   latency us: min {d['min'] * 1e6:8.1f} | "
                      f"p50 {d['p50'] * 1e6:8.1f} | "
                      f"p95 {d['p95'] * 1e6:8.1f} | "
                      f"max {d['max'] * 1e6:8.1f} |")
        if verify_against is None and (outdir is None or filename is None):
            return self.results  # nothing consumes outputs; saving needs
            # BOTH outdir and filename
        for op in self.operations:
            if not op.prefix:
                continue
            op.run()
            output = op.fetch()
            if outdir is not None and filename is not None:
                save_image(os.path.join(outdir, f"{op.prefix}-{filename}"),
                           output)
            if verify_against is not None:
                expected = verify_ops[op.csv_column](verify_against)
                delta = np.abs(output.astype(np.int32)
                               - expected.astype(np.int32))
                if delta.max(initial=0) > verify_atol:
                    diff = int(np.sum(delta > verify_atol))
                    failures.append(
                        f"{op.csv_column}: {diff} px differ "
                        f"(max |delta| = {int(delta.max())})")
        if failures:
            raise AssertionError(
                "Output verification against oracle FAILED: "
                + "; ".join(failures))
        return self.results

    def write_csv(self, path: str, tool: str) -> None:
        reporting.write_csv(path, tool, self.results)


def op_matrix_entry(csv_column: str) -> tuple[str, str, str]:
    for desc, prefix, col in spec.OPERATION_MATRIX:
        if col == csv_column:
            return desc, prefix, col
    raise KeyError(csv_column)
