"""crop_ms: the host's crop of a batch's result to its (B, H, W, 3)
images, in ms an image: the port's ``crop`` span's total over the images
the batch tool returned, in the traced sub-window."""

from dipbench.metrics import _port


def read(ctx):
    snap = _port.snapshot()
    crop, images = _port.span(snap, "crop"), _port.counter(snap, "images")
    return None if crop is None or images is None else crop[1] / images / 1e6
