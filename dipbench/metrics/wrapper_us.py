"""wrapper_us: the mean host time, in µs, of an op's wrapper in the
port's op table without its output's allocation and its kernel's launch:
the checks, the dispatch and the argument packing. The self time of the
port's ``op`` span over its calls, in the traced sub-window."""

from dipbench.metrics import _port


def read(ctx):
    op = _port.span(_port.snapshot(), "op")
    return None if op is None else op[2] / op[0] / 1e3
