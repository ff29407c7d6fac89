"""The batch tool's crop of a planar stack on the card: ``crop_u8``
(csrc/layout.cu, through ``ops/layout.crop_stack``) held to
``utils/image.from_planar_padded`` at tolerance 0, on planar stacks of
random bytes (halo and slack included, which the crop must leave out) and
on ``bake_u8``'s output, its round trip.

The tests here are card-only and skip without a CUDA device. They need
neither JAX nor ``conftest.py``:

    python -m pytest --noconftest tests/test_torch_crop.py -m cuda

``CROP_CASES``, ``CHAIN8`` and ``planar_case`` are shared with the plain
crop's tests in tests/test_torch_layout.py.
"""

import numpy as np
import pytest
import torch

from dip_benchmark_tpu_torch.ops import kernels
from dip_benchmark_tpu_torch.ops.layout import bake_stack, crop_stack
from dip_benchmark_tpu_torch.runtime import tracing
from dip_benchmark_tpu_torch.utils.image import (from_planar_padded,
                                                 make_layout)
from test_torch_bake import BAKE_CASES, bake_case, card

# A chain of radius 8, the deepest halo the batch tool's chains take.
CHAIN8 = ("Convolution-5x5", "Convolution-1x5+5x1", "Convolution-5x5",
          "Gaussian-Blur-3x3", "Erosion-3x3-Square")

# The bake's cases, and a chain's layout of pad 8 at 24x40 (rows of 120
# bytes: every other row starts off a 16-byte boundary).
CROP_CASES = BAKE_CASES + [(2, 24, 40, 8)]

# Beyond them on the card: the fundus stack of the batch cell; rows of
# 3,003 bytes; three tiles of 4,096 columns; a tile's edge one column
# short of the image's.
CARD_CASES = CROP_CASES + [(8, 2336, 3504, 2), (2, 64, 1001, 3),
                           (1, 9, 9000, 8), (2, 7, 4095, 5)]


def planar_case(b, h, w, pad, seed=0):
    """A ``(B, 3, Hp, pitch)`` stack of random bytes and its layout."""
    layout = make_layout(h, w, pad=pad)
    planar = np.random.default_rng(seed + 31 * pad + w).integers(
        0, 256, (b,) + layout.shape, np.uint8)
    return torch.from_numpy(planar), layout


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,pad", CARD_CASES)
def test_crop_stack_on_card_is_the_host_crop(b, h, w, pad):
    card()
    planar, layout = planar_case(b, h, w, pad)
    kernels.reset_launches()
    got = crop_stack(planar.cuda(), layout)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"crop_u8": 1}
    assert got.is_contiguous() and got.shape == (b, h, w, 3)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  from_planar_padded(planar, layout))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,pad", CROP_CASES + [(8, 2336, 3504, 2)])
def test_crop_stack_on_card_undoes_bake_u8(b, h, w, pad):
    card()
    images, layout = bake_case(b, h, w, pad)
    kernels.reset_launches()
    tracing.enable()
    try:
        got = crop_stack(bake_stack(torch.from_numpy(images).cuda(), layout),
                         layout)
        snap = tracing.snapshot()
    finally:
        tracing.disable()
    assert kernels.LAUNCHES == {"bake_u8": 1, "crop_u8": 1}
    assert snap.counters["card_crops"] == snap.counters["card_bakes"] == b
    np.testing.assert_array_equal(got.cpu().numpy(), images)
