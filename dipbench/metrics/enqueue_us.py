"""enqueue_us: the mean host time, in µs, from the call of an op's
entry in the port's op table to its return, before the round's
synchronize: the wrappers' checks, the output's allocation and the
kernel's launch. The benchmark's own span, over every round of the
measured window of a traced run (the profiler is off then)."""


def read(ctx):
    s = ctx.spans
    if s is None or not s.enqueue_calls:
        return None
    return s.enqueue_ns / 1e3 / s.enqueue_calls
