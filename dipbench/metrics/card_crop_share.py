"""card_crop_share: the share of the images the batch tool returned whose
result was cropped on the card, in %: the port's ``card_crops`` counter
over its ``images`` counter, in the traced sub-window. Nothing where the
port counts no crop on the card."""

from dipbench.metrics import _port


def read(ctx):
    snap = _port.snapshot()
    crops, images = (_port.counter(snap, "card_crops"),
                     _port.counter(snap, "images"))
    return None if crops is None or images is None else 100.0 * crops / images
