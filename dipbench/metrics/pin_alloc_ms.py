"""pin_alloc_ms: the page-locked allocations of a batch (its input
stack's and its result's, ``torch.empty(..., pin_memory=True)``), in ms
an image: the port's ``pin_alloc`` span's total over the images the
batch tool returned, in the traced sub-window."""

from dipbench.metrics import _port


def read(ctx):
    snap = _port.snapshot()
    pin, images = _port.span(snap, "pin_alloc"), _port.counter(snap,
                                                               "images")
    return None if pin is None or images is None else pin[1] / images / 1e6
