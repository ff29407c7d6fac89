"""device_idle_pct: the device's idle share of the measured window, in %.

The window's device busy time is each kind of round's mean busy time in
the traced sub-window (the union of the device intervals of its kernels,
copies and sets, put in the round by correlation id), times the rounds
of that kind the window ran (whole cycles, so the window count over the
kinds); the idle share is 100 (1 - that / the window's length). The busy
time comes from the trace and the rounds and the length from the
untraced window, so the profiler's own host cost, which stretches the
gaps between the traced rounds, is not counted as idle. Nothing without
a trace."""


def read(ctx):
    if ctx.trace is None or ctx.window is None:
        return None
    busy = ctx.trace.busy_by_kind()
    if not busy:
        return None
    cycles = ctx.window.rounds / len(busy)
    busy_us = cycles * sum(busy.values())
    return 100.0 * (1.0 - busy_us / (ctx.window.seconds * 1e6))
