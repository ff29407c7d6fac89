"""sync_wait_us: the mean host time, in µs, of the synchronize that ends
a session round: the rest of the round's device work plus the call's own
cost. The port's ``sync`` span's total over its calls, in the traced
sub-window."""

from dipbench.metrics import _port


def read(ctx):
    sync = _port.span(_port.snapshot(), "sync")
    return None if sync is None else sync[1] / sync[0] / 1e3
