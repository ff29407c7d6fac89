"""The port's morphology library surface (K19 and the generic structuring
element): ``window.make_dilation``/``make_erosion`` and ``f32.make_erosion``
against the JAX package's make_* functions, the oracle and the min/max duality.

The JAX functions run in Pallas interpret mode on the CPU, on the JAX
planar; the port gets the identical buffer through ``from_jax_planar`` and,
on CPU tensors, runs ``window.morphology_plain``. The JAX kernels leave
lane-roll garbage in the outer columns, so the two are compared on the
crop. Min and max are exact in any order, so every comparison is at
tolerance 0, in both data models. The card-only tests at the end hold the
kernels against the plain versions and skip without a card.
"""

import jax
import numpy as np
import pytest
import torch

from dip_benchmark_tpu.ops.pallas import f32 as jax_f32
from dip_benchmark_tpu.ops.pallas import window as jax_window
from dip_benchmark_tpu.utils import image as jax_image
from dip_benchmark_tpu_torch import oracle, oracle_f32, spec
from dip_benchmark_tpu_torch.ops import f32, kernels, window
from dip_benchmark_tpu_torch.utils.image import (from_jax_planar,
                                                 from_planar_padded,
                                                 from_planar_padded_f32,
                                                 make_layout,
                                                 to_planar_padded,
                                                 to_planar_padded_f32)

DIAMOND_5X5 = np.array([[0, 0, 1, 0, 0], [0, 1, 1, 1, 0], [1, 1, 1, 1, 1],
                        [0, 1, 1, 1, 0], [0, 0, 1, 0, 0]], bool)
RING_5X5 = np.ones((5, 5), bool)
RING_5X5[1:4, 1:4] = False
ELEMENTS = {
    "square-3x3": spec.SQUARE_MASK_3X3,
    "cross-3x3": spec.CROSS_MASK_3X3,
    "diamond-5x5": DIAMOND_5X5,
    "ring-5x5": RING_5X5,
    "row-1x5": np.ones((1, 5), bool),
    "square-5x5": np.ones((5, 5), bool),
}
# Element -> the kernel each make_* function routes it to.
KERNELS = {
    "square-3x3": ("window_u8<MinRect>", "window_u8<MaxRect>",
                   "window_f32<MinRect>"),
    "cross-3x3": ("window_u8<MinPlus>", "window_u8<MaxPlus>",
                  "window_f32<MinPlus>"),
    "diamond-5x5": ("window_u8<Taps<Min>>", "window_u8<Taps<Max>>",
                    "window_f32<Taps<Min>>"),
    "ring-5x5": ("window_u8<Taps<Min>>", "window_u8<Taps<Max>>",
                 "window_f32<Taps<Min>>"),
    "row-1x5": ("window_u8<Taps<Min>>", "window_u8<Taps<Max>>",
                "window_f32<Taps<Min>>"),
    "square-5x5": ("window_u8<Taps<Min>>", "window_u8<Taps<Max>>",
                   "window_f32<Taps<Min>>"),
}
# Elements wider than the default halo, on a layout of their radius.
LARGE = {
    "square-17x17": np.ones((17, 17), bool),
    "disc-9x9": np.add.outer(np.arange(-4, 5) ** 2,
                             np.arange(-4, 5) ** 2) <= 16,
    "frame-15x11": np.pad(np.zeros((13, 9), bool), 1, constant_values=True),
}


def crop_u8(planar: torch.Tensor, layout) -> np.ndarray:
    return from_planar_padded(planar, layout)


@pytest.mark.parametrize("name", ["square-3x3", "cross-3x3", "diamond-5x5",
                                  "square-5x5"])
@pytest.mark.parametrize("which", ["dilation", "erosion"])
def test_uint8_matches_jax_morphology_and_oracle(which, name, small_image):
    mask = ELEMENTS[name]
    jax_layout = jax_image.make_layout(*small_image.shape[:2])
    jax_planar = jax_image.to_planar_padded(small_image, jax_layout)
    jax_make = (jax_window.make_dilation if which == "dilation"
                else jax_window.make_erosion)
    taps = jax_window.mask_to_taps(mask)
    want = jax_image.from_planar_padded(np.asarray(jax_make(jax_layout, taps)(
        jax.device_put(jax_planar))), jax_layout)
    layout = make_layout(*small_image.shape[:2])
    make = window.make_dilation if which == "dilation" else window.make_erosion
    assert window.mask_to_taps(mask) == taps
    got = crop_u8(make(layout, taps)(from_jax_planar(jax_planar, jax_layout)),
                  layout)
    np.testing.assert_array_equal(got, want)
    ref = oracle.dilation if which == "dilation" else oracle.erosion
    np.testing.assert_array_equal(got, ref(small_image, mask))


@pytest.mark.parametrize("name", ["square-3x3", "diamond-5x5"])
def test_float32_erosion_matches_jax_erosion_and_oracle(name, small_image):
    mask = ELEMENTS[name]
    h, w, _ = small_image.shape
    jax_layout = jax_image.make_layout(h, w, itemsize=4)
    jax_planar = jax_image.to_planar_padded_f32(small_image, jax_layout)
    taps = jax_window.mask_to_taps(mask)
    out = np.asarray(jax_f32._make_erosion(jax_layout, taps)(
        jax.device_put(jax_planar)))
    layout = make_layout(h, w)
    got = f32.make_erosion(layout, taps)(
        from_jax_planar(jax_planar, jax_layout))
    p = layout.pad
    want = from_jax_planar(out, jax_layout)[:, p:p + h, p:p + w]
    assert torch.equal(got[:, p:p + h, p:p + w], want)
    np.testing.assert_array_equal(
        got[:, p:p + h, p:p + w].numpy(),
        oracle_f32.erosion(oracle_f32.from_uint8_hwc(small_image), mask))


@pytest.mark.parametrize("name", sorted(ELEMENTS))
def test_dilation_is_the_dual_of_erosion(name, gradient_image):
    taps = window.mask_to_taps(ELEMENTS[name])
    layout = make_layout(*gradient_image.shape[:2])
    dilate = window.make_dilation(layout, taps)
    erode = window.make_erosion(layout, taps)
    got = crop_u8(dilate(to_planar_padded(gradient_image, layout)), layout)
    dual = 255 - crop_u8(erode(to_planar_padded(255 - gradient_image,
                                                layout)), layout)
    np.testing.assert_array_equal(got, dual)
    np.testing.assert_array_equal(got, oracle.dilation(gradient_image,
                                                       ELEMENTS[name]))


@pytest.mark.parametrize("name", sorted(ELEMENTS))
def test_every_element_matches_the_oracle_in_both_models(name, small_image):
    mask = ELEMENTS[name]
    taps = window.mask_to_taps(mask)
    layout = make_layout(*small_image.shape[:2])
    got = crop_u8(window.make_erosion(layout, taps)(
        to_planar_padded(small_image, layout)), layout)
    np.testing.assert_array_equal(got, oracle.erosion(small_image, mask))
    got = from_planar_padded_f32(f32.make_erosion(layout, taps)(
        to_planar_padded_f32(small_image, layout)), layout)
    np.testing.assert_array_equal(got, oracle_f32.to_uint8_hwc(
        oracle_f32.erosion(oracle_f32.from_uint8_hwc(small_image), mask)))


@pytest.mark.parametrize("name", sorted(ELEMENTS))
def test_routing_by_structure(name):
    taps = window.mask_to_taps(ELEMENTS[name])
    layout = make_layout(8, 8)
    got = (window.make_erosion(layout, taps).kernel,
           window.make_dilation(layout, taps).kernel,
           f32.make_erosion(layout, taps).kernel)
    assert got == KERNELS[name]
    assert window._tap_structure(taps) == jax_window._tap_structure(taps)


def test_ring_is_the_elements_extent(gradient_image):
    # A 1x5 row: 0 in the outer 2 columns only, not in any row.
    taps = window.mask_to_taps(ELEMENTS["row-1x5"])
    layout = make_layout(*gradient_image.shape[:2])
    out = window.make_dilation(layout, taps)(
        to_planar_padded(gradient_image // 2 + 100, layout))
    assert bool((out[:, :, :2] == 0).all()) and bool(
        (out[:, :, -2:] == 0).all())
    assert bool((out[:, :, 2:-2] > 0).all())


def test_element_wider_than_the_halo_is_refused_by_both_packages():
    taps = window.mask_to_taps(np.ones((7, 7), bool))  # radius 3 > halo 2
    with pytest.raises(ValueError, match="exceeds the layout halo"):
        jax_window.make_dilation(jax_image.make_layout(16, 16), taps)
    with pytest.raises(ValueError, match="exceeds the layout halo"):
        window.make_dilation(make_layout(16, 16), taps)
    with pytest.raises(ValueError, match="exceeds the layout halo"):
        f32.make_erosion(make_layout(16, 16), taps)
    # A layout with the element's halo takes it.
    layout = make_layout(16, 16, pad=3)
    window.make_dilation(layout, taps)(torch.zeros(layout.shape,
                                                   dtype=torch.uint8))


def test_wrapper_checks_its_input():
    layout = make_layout(8, 8)
    fn = window.make_erosion(layout, window.mask_to_taps(DIAMOND_5X5))
    with pytest.raises(ValueError, match="built for"):
        fn(torch.zeros(make_layout(9, 8).shape, dtype=torch.uint8))
    with pytest.raises(ValueError):
        fn(torch.zeros(layout.shape, dtype=torch.float32))
    with pytest.raises(ValueError, match="meta"):
        fn(torch.empty(layout.shape, dtype=torch.uint8, device="meta"))


def test_cpu_tensors_launch_no_kernel(small_image):
    layout = make_layout(*small_image.shape[:2])
    planar = to_planar_padded(small_image, layout)
    kernels.reset_launches()
    for mask in ELEMENTS.values():
        window.make_dilation(layout, window.mask_to_taps(mask))(planar)
    assert kernels.LAUNCHES == {}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ELEMENTS))
def test_kernels_match_plain_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    taps = window.mask_to_taps(ELEMENTS[name])
    rng = np.random.default_rng(3)
    layout = make_layout(37, 53)
    for make, bake, reduce in (
            (window.make_dilation, to_planar_padded, torch.maximum),
            (window.make_erosion, to_planar_padded, torch.minimum),
            (f32.make_erosion, to_planar_padded_f32, torch.minimum)):
        fn = make(layout, taps)
        kernels.reset_launches()
        for _ in range(3):  # three images, one launch each
            image = rng.integers(0, 256, (37, 53, 3), np.uint8)
            planar = bake(image, layout).cuda()
            got = fn(planar)
            torch.cuda.synchronize()
            assert torch.equal(got, window.morphology_plain(planar, taps,
                                                            reduce))
        assert kernels.LAUNCHES == {fn.kernel: 3}


@pytest.mark.parametrize("name", sorted(LARGE))
def test_large_elements_match_the_oracle(name, small_image):
    mask = LARGE[name]
    taps = window.mask_to_taps(mask)
    layout = make_layout(*small_image.shape[:2], pad=max(mask.shape) // 2)
    got = crop_u8(window.make_dilation(layout, taps)(
        to_planar_padded(small_image, layout)), layout)
    np.testing.assert_array_equal(got, oracle.dilation(small_image, mask))
    got = from_planar_padded_f32(f32.make_erosion(layout, taps)(
        to_planar_padded_f32(small_image, layout)), layout)
    np.testing.assert_array_equal(got, oracle_f32.to_uint8_hwc(
        oracle_f32.erosion(oracle_f32.from_uint8_hwc(small_image), mask)))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(LARGE))
def test_large_elements_match_plain_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    mask = LARGE[name]
    taps = window.mask_to_taps(mask)
    rng = np.random.default_rng(4)
    for h, w in ((9, 9), (37, 53), (130, 250)):
        layout = make_layout(h, w, pad=max(mask.shape) // 2)
        image = rng.integers(0, 256, (h, w, 3), np.uint8)
        for make, bake, reduce in (
                (window.make_dilation, to_planar_padded, torch.maximum),
                (window.make_erosion, to_planar_padded, torch.minimum),
                (f32.make_erosion, to_planar_padded_f32, torch.minimum)):
            planar = bake(image, layout).cuda()
            got = make(layout, taps)(planar)
            torch.cuda.synchronize()
            assert torch.equal(got, window.morphology_plain(planar, taps,
                                                            reduce))
