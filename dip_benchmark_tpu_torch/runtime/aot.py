"""Warm start: everything a timed table needs, done before the timing.

The port of ``warm`` from ``dip_benchmark_tpu/runtime/aot.py``. The JAX
package compiles each op ahead of time there; the port has nothing to
compile per op, since the kernel library is built when the session is
built (``session.BenchmarkSession``). What is left is the first
application of each op: the first launch of each kernel, the caching
allocator's first blocks for its output, a chain's descriptor, and in a
``--chained`` table the capture of the CUDA graph its rows replay. So
``warm`` runs each row of the table once, untimed, as the JAX CLI's
``--warm`` does; the "once" column then shows a warm launch.

The JAX package's ``export_ops``/``load_exported`` (a StableHLO export
for serving without the framework) are not ported: a compiled CUDA
library and a PyTorch program have no such artifact.
"""

from __future__ import annotations


def warm(table) -> int:
    """Run every row of ``table`` (``harness.Operation``s) once, except
    the rows that download to the host; returns how many ran."""
    rows = [op for op in table if not op.downloads]
    for op in rows:
        op.run()
    return len(rows)
