"""Each op of the port against the JAX package's Pallas op and the oracle.

Inputs are the conftest images. The JAX op runs as tests/test_pallas_ops.py
runs it (Pallas interpret mode on the CPU); the port gets the identical
planar buffer through from_jax_planar and, on CPU tensors, runs each op's
plain PyTorch version. Tolerance is 0 everywhere: the uint8 model is
bit-exact by spec. The card-only test at the end holds the CUDA kernels
against the same plain versions; it skips without a CUDA device.
"""

import jax
import numpy as np
import pytest
import torch

from dip_benchmark_tpu import oracle, spec
from dip_benchmark_tpu.ops import pallas
from dip_benchmark_tpu.utils import image as jax_image
from dip_benchmark_tpu_torch.ops import OPS, PLAIN, window
from dip_benchmark_tpu_torch.utils.image import (from_jax_planar,
                                                 from_planar_padded,
                                                 make_layout, to_planar_padded)

COLS = sorted(OPS)
POINT_COLS = ("Copy", "Inversion", "Grayscale", "Threshold")
RADIUS = {"Convolution-5x5": 2, "Convolution-1x5+5x1": 2,
          "Fused-Pipeline": 2}  # others: 1


def run_port(col: str, image: np.ndarray) -> np.ndarray:
    layout = make_layout(*image.shape[:2])
    out = OPS[col](to_planar_padded(image, layout))
    return from_planar_padded(out, layout)


def test_registry_covers_the_device_columns():
    # The 12 device columns of the matrix and the --pipeline row, as the
    # JAX package's build_ops registers them.
    assert set(OPS) == set(PLAIN) == set(pallas.build_ops(
        jax_image.make_layout(8, 8))) == {
        c for c in spec.CSV_COLUMNS
        if c not in ("Upload", "Download")} | {"Fused-Pipeline"}


@pytest.mark.parametrize("col", COLS)
def test_port_matches_jax_pallas_and_oracle(col, small_image):
    h, w = small_image.shape[:2]
    jax_layout = jax_image.make_layout(h, w)
    jax_planar = jax_image.to_planar_padded(small_image, jax_layout)
    jax_out = pallas.build_ops(jax_layout)[col](jax.device_put(jax_planar))
    want = pallas.build_crops(jax_layout)[col](jax_out)

    layout = make_layout(h, w)
    out = OPS[col](from_jax_planar(jax_planar, jax_layout))
    got = from_planar_padded(out, layout)
    np.testing.assert_array_equal(got, want, err_msg=col)
    np.testing.assert_array_equal(got, oracle.IMAGE_OPS[col](small_image),
                                  err_msg=col)


@pytest.mark.parametrize("fixture", ["gradient_image", "fundus_crop"])
@pytest.mark.parametrize("col", COLS)
def test_port_matches_oracle(col, fixture, request):
    image = request.getfixturevalue(fixture)
    np.testing.assert_array_equal(run_port(col, image),
                                  oracle.IMAGE_OPS[col](image), err_msg=col)


@pytest.mark.parametrize("col", COLS)
def test_port_matches_oracle_smallest_image(col):
    image = np.random.default_rng(5).integers(0, 256, (5, 5, 3), np.uint8)
    np.testing.assert_array_equal(run_port(col, image),
                                  oracle.IMAGE_OPS[col](image), err_msg=col)


@pytest.mark.parametrize("col", POINT_COLS)
def test_point_ops_keep_the_mirror_halo(col, small_image):
    # Point ops run over the whole buffer and commute with mirroring.
    layout = make_layout(*small_image.shape[:2])
    out = OPS[col](to_planar_padded(small_image, layout))
    want = to_planar_padded(oracle.IMAGE_OPS[col](small_image), layout)
    assert torch.equal(out, want)


@pytest.mark.parametrize("col", sorted(set(COLS) - set(POINT_COLS)))
def test_window_ops_write_a_zero_ring(col, gradient_image):
    # 255 - image has no zero pixel, so the ring is the only zero region.
    image = 255 - gradient_image // 2
    layout = make_layout(*image.shape[:2])
    out = OPS[col](to_planar_padded(image, layout))
    r = RADIUS.get(col, 1)
    inner = torch.zeros_like(out, dtype=torch.bool)
    inner[:, r:-r, r:-r] = True
    assert not bool(out[~inner].any())
    assert bool(out[inner].all())


def test_separable_convolution_rounds_between_passes(fundus_crop):
    # The 1x3+3x1 answer rounds the horizontal pass to u8 before the
    # vertical one; one rounding of the outer-product mask differs.
    planar = to_planar_padded(fundus_crop, make_layout(*fundus_crop.shape[:2]))
    two = window.conv_sep_plain(planar, spec.BLUR_1X3_INT, spec.BLUR_3X1_INT,
                                spec.BLUR_SEP3_SHIFT)
    one = window.conv_dense_plain(planar, spec.BLUR_3X3_INT,
                                  spec.BLUR_3X3_SHIFT)
    assert not torch.equal(two, one)


@pytest.mark.parametrize("masks", [
    # Sides past 17 or of 0 (every side 1 to 17 has a kernel:
    # tests/test_torch_conv_shapes.py), separable pairs that disagree.
    (np.ones((18, 18), np.int32), None),
    (np.ones((1, 18), np.int32), None),
    (np.ones((18, 3), np.int32), None),
    (np.ones((0, 3), np.int32), None),
    (spec.BLUR_1X3_INT, spec.BLUR_5X1_INT),
    (spec.BLUR_3X1_INT, spec.BLUR_1X3_INT),
])
def test_convolution_refuses_masks_without_a_kernel(masks, small_image):
    planar = to_planar_padded(small_image, make_layout(*small_image.shape[:2]))
    row, col = masks
    with pytest.raises(ValueError, match="no .*kernel"):
        if col is None:
            window.convolution(planar, row, 4)
        else:
            window.convolution_separated(planar, row, col, 2)


@pytest.mark.parametrize("mask", [
    np.array([[1, 0, 1], [0, 1, 0], [1, 0, 1]], bool),
    np.ones((5, 5), bool),
])
def test_erosion_refuses_masks_without_a_kernel(mask, small_image):
    planar = to_planar_padded(small_image, make_layout(*small_image.shape[:2]))
    with pytest.raises(ValueError, match="no erosion kernel"):
        window.erosion(planar, mask)


@pytest.mark.cuda
@pytest.mark.parametrize("col", COLS)
def test_kernel_matches_plain_on_card(col, small_image, fundus_crop):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    for image in (small_image, fundus_crop):
        layout = make_layout(*image.shape[:2])
        planar = to_planar_padded(image, layout).cuda()
        got = OPS[col](planar)
        torch.cuda.synchronize()
        assert got.is_cuda
        assert torch.equal(got, PLAIN[col](planar))
        np.testing.assert_array_equal(from_planar_padded(got, layout),
                                      oracle.IMAGE_OPS[col](image))
