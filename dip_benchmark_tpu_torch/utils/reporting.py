"""Result reporting: stdout markdown rows + programmatic results.csv writer.

The port's own copy of ``dip_benchmark_tpu/utils/reporting.py``.

The reference prints one markdown row per op and relies on humans to copy
numbers into assets/results.csv (SURVEY.md §1 L5). We print the identical row
format [opencv/benchmark.py:111, sycl/benchmark.cpp:368] AND write the CSV row
programmatically in the exact schema plot.py reads [plot.py:6-18,
assets/results.csv:1], closing the manual gap without breaking plot.py.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from .. import spec


@dataclass
class OpResult:
    description: str
    prefix: str
    csv_column: str
    time_once: float
    time_rounds: float
    rounds: int = 10000


def format_row(result: OpResult, rounds: int | None = None,
               width: int = 0) -> str:
    """Byte-compatible with the reference row printers."""
    n = result.rounds if rounds is None else rounds
    return (f"| {result.description: <{width}} "
            f"| {result.time_once:10.6f}s (once) "
            f"| {result.time_rounds:10.6f}s ({n} times) |")


def print_results(results: list[OpResult], rounds: int) -> None:
    width = max(len(r.description) for r in results)
    for r in results:
        print(format_row(r, rounds, width))


def csv_row(tool: str, results: list[OpResult]) -> str:
    """One results.csv row: per-round seconds in CSV_COLUMNS order."""
    by_col = {r.csv_column: r for r in results}
    cells = [f"{by_col[col].time_rounds:.6f}" if col in by_col else ""
             for col in spec.CSV_COLUMNS]
    return tool + "," + ",".join(cells)


def write_csv(path: str, tool: str, results: list[OpResult]) -> None:
    """Create or update a results.csv, replacing any existing row for `tool`."""
    lines: list[str] = []
    if os.path.exists(path):
        with open(path) as f:
            # rstrip \r too: a CRLF checkout must not fail the header
            # match below and lose the other tools' rows.
            lines = [ln.rstrip("\r\n") for ln in f if ln.strip()]
    if lines and lines[0] != spec.CSV_HEADER:
        # Never silently clobber a file we don't recognize — the update
        # contract is "replace MY tool's row", not "rewrite the file".
        raise ValueError(
            f"{path} exists but its header doesn't match the reference "
            f"results.csv schema (got {lines[0][:60]!r}); refusing to "
            f"rewrite it")
    if not lines:
        lines = [spec.CSV_HEADER]
    lines = [lines[0]] + [ln for ln in lines[1:]
                          if ln.split(",", 1)[0] != tool]
    lines.append(csv_row(tool, results))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
