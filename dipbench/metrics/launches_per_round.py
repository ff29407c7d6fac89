"""launches_per_round: the kernel launches a session round makes: the
port's ``launch`` span's calls over its ``sync`` span's (one a round), in
the traced sub-window."""

from dipbench.metrics import _port


def read(ctx):
    snap = _port.snapshot()
    launch, sync = _port.span(snap, "launch"), _port.span(snap, "sync")
    return None if launch is None or sync is None else launch[0] / sync[0]
