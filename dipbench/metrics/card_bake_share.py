"""card_bake_share: the share of the images the batch tool returned whose
planar layout was baked on the card, in %: the port's ``card_bakes``
counter over its ``images`` counter, in the traced sub-window. Nothing
where the port counts no bake on the card."""

from dipbench.metrics import _port


def read(ctx):
    snap = _port.snapshot()
    bakes, images = (_port.counter(snap, "card_bakes"),
                     _port.counter(snap, "images"))
    return None if bakes is None or images is None else 100.0 * bakes / images
