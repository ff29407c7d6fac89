"""launch_us: the mean host time, in µs, of one kernel launch
(``ops/kernels`` ``launch``: the library's load, the device context, the
stream lookup, the ctypes call and its status check): the port's
``launch`` span's total over its calls, in the traced sub-window."""

from dipbench.metrics import _port


def read(ctx):
    launch = _port.span(_port.snapshot(), "launch")
    return None if launch is None else launch[1] / launch[0] / 1e3
