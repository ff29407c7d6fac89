"""f32_kernels_roofline: the float32 matrix kernels' share of their
roofline, in %, over the traced rounds of chained traffic: the sum over
the rounds of k applications' bounds (``dipbench/counts.py``: the
logical image read once and written once at the HBM rate, or its
operations at the FP32 rate, whichever is longer) over the sum of the
device time of the kernels each round launched."""

from dipbench import counts


def read(ctx):
    if ctx.trace is None or "k" not in ctx.mix:
        return None
    h, w, dtype = ctx.cfg["height"], ctx.cfg["width"], ctx.cfg["dtype"]
    k = int(ctx.mix["k"])
    rounds = [r for r in ctx.trace.rounds if r.kernel_us > 0]
    if not rounds:
        return None
    bound_us = sum(k * counts.bound_s(r.name, h, w, dtype) * 1e6
                   for r in rounds)
    return 100.0 * bound_us / sum(r.kernel_us for r in rounds)
