"""alloc_us: the host time, in µs, that an op of the port's op table
spends allocating its output (``torch.empty_like``): the port's ``alloc``
span's total over the ``op`` span's calls, in the traced sub-window."""

from dipbench.metrics import _port


def read(ctx):
    snap = _port.snapshot()
    alloc, op = _port.span(snap, "alloc"), _port.span(snap, "op")
    return None if alloc is None or op is None else alloc[1] / op[0] / 1e3
