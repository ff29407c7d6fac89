"""fetch_wait_ms: the host's wait for a batch's copy back that nothing
hid, in ms an image: the port's ``fetch`` span's total over the images the
batch tool returned (its ``images`` counter), in the traced sub-window.
Nothing where the port has no such span."""

from dipbench.metrics import _port


def read(ctx):
    snap = _port.snapshot()
    fetch, images = _port.span(snap, "fetch"), _port.counter(snap, "images")
    return None if fetch is None or images is None else fetch[1] / images / 1e6
