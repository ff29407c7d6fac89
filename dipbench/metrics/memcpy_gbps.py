"""memcpy_gbps: the rate of the copies between the host and the card, in
GB/s: the bytes of every copy launched in the traced rounds (as
the trace records them) over those copies' device time."""


def read(ctx):
    if ctx.trace is None:
        return None
    nbytes = sum(r.copy_bytes for r in ctx.trace.rounds)
    us = sum(r.copy_us for r in ctx.trace.rounds)
    return nbytes / us / 1e3 if nbytes and us else None
