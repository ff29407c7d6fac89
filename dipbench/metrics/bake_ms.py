"""bake_ms: the host's layout bake, in ms an image: the NumPy mirror
gather of a batch's images into its planar stack, without the stack's
page-locked allocation. The self time of the port's ``bake`` span over
the images the batch tool returned (its ``images`` counter), in the
traced sub-window."""

from dipbench.metrics import _port


def read(ctx):
    snap = _port.snapshot()
    bake, images = _port.span(snap, "bake"), _port.counter(snap, "images")
    return None if bake is None or images is None else bake[2] / images / 1e6
