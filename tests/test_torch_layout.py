"""The port's planar layout: round trip, baked mirror halo, pitch, and the
carry-across of the JAX package's planar buffer (from_jax_planar)."""

import numpy as np
import pytest

from dip_benchmark_tpu.utils import image as jax_image
from dip_benchmark_tpu_torch.utils.image import (PITCH_ALIGN, from_jax_planar,
                                                 from_planar_padded,
                                                 make_layout, to_planar_padded)

FIXTURES = ("small_image", "gradient_image", "fundus_crop")


@pytest.mark.parametrize("fixture", FIXTURES)
def test_planar_roundtrip(fixture, request):
    image = request.getfixturevalue(fixture)
    layout = make_layout(*image.shape[:2])
    planar = to_planar_padded(image, layout)
    assert tuple(planar.shape) == layout.shape
    assert planar.is_contiguous()
    np.testing.assert_array_equal(from_planar_padded(planar, layout), image)


@pytest.mark.parametrize("hw", [(5, 5), (37, 53), (24, 40), (2336, 3504)])
def test_layout_geometry(hw):
    layout = make_layout(*hw)
    h, w = hw
    assert layout.pad == 2
    assert layout.padded_height == h + 4
    assert layout.pitch % PITCH_ALIGN == 0
    assert w + 4 <= layout.pitch < w + 4 + PITCH_ALIGN


def test_planar_padding_is_mirror(gradient_image):
    layout = make_layout(*gradient_image.shape[:2])
    ch0 = to_planar_padded(gradient_image, layout).numpy()[0]
    p, h, w = layout.pad, layout.height, layout.width
    img0 = gradient_image[..., 0]
    # col halo: index -1 -> 1, -2 -> 2; w -> w-1, w+1 -> w-2
    np.testing.assert_array_equal(ch0[p:p + h, p - 1], img0[:, 1])
    np.testing.assert_array_equal(ch0[p:p + h, p - 2], img0[:, 2])
    np.testing.assert_array_equal(ch0[p:p + h, p + w], img0[:, -1])
    np.testing.assert_array_equal(ch0[p:p + h, p + w + 1], img0[:, -2])
    # row halo: -1 -> 1, -2 -> 2; h -> h-1, h+1 -> h-2
    np.testing.assert_array_equal(ch0[p - 1, p:p + w], img0[1, :])
    np.testing.assert_array_equal(ch0[p - 2, p:p + w], img0[2, :])
    np.testing.assert_array_equal(ch0[p + h, p:p + w], img0[-1, :])
    np.testing.assert_array_equal(ch0[p + h + 1, p:p + w], img0[-2, :])
    # alignment slack follows the clamped mirror rule: it continues the
    # reflection and clamps at column 0
    xs = np.clip(2 * w - np.arange(w + 2, layout.pitch - p) - 1, 0, w - 1)
    np.testing.assert_array_equal(ch0[p:p + h, p + w + 2:], img0[:, xs])


@pytest.mark.parametrize("fixture", FIXTURES)
def test_from_jax_planar_equals_port_planar(fixture, request):
    image = request.getfixturevalue(fixture)
    h, w = image.shape[:2]
    jax_layout = jax_image.make_layout(h, w)
    recut = from_jax_planar(jax_image.to_planar_padded(image, jax_layout),
                            jax_layout)
    own = to_planar_padded(image, make_layout(h, w))
    assert recut.is_contiguous()
    assert recut.dtype == own.dtype and recut.shape == own.shape
    assert bool((recut == own).all())


def test_from_jax_planar_refuses_a_short_buffer(small_image):
    jax_layout = jax_image.make_layout(*small_image.shape[:2])
    arr = jax_image.to_planar_padded(small_image, jax_layout)
    with pytest.raises(ValueError, match="cannot hold"):
        from_jax_planar(arr[:, :, :16], jax_layout)


def test_layout_refuses_images_smaller_than_the_halo():
    with pytest.raises(ValueError, match="at least 3x3"):
        make_layout(2, 40)
    with pytest.raises(ValueError, match="does not fit"):
        to_planar_padded(np.zeros((5, 6, 3), np.uint8), make_layout(5, 5))
