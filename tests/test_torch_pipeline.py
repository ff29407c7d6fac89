"""The fused pipeline (K11) of the port against the JAX package's Pallas
kernel and the oracle, single and batched.

The JAX kernel runs as tests/test_batch.py runs it (Pallas interpret mode
on the CPU); the port gets the identical planar buffer through
from_jax_planar and, on CPU tensors, runs fused_pipeline_plain. The JAX
kernel leaves its rows below the halo stale and its slack rows unwritten,
so it is compared on the crop only; the port's whole buffer is pinned
against the composition of its plain ops. Tolerance 0 everywhere: the
uint8 model is bit-exact by spec. The card-only tests at the end hold the
CUDA kernel against the same plain version; they skip without a card.
"""

import os
import re

import jax
import numpy as np
import pytest
import torch

from dip_benchmark_tpu import oracle as jax_oracle
from dip_benchmark_tpu import spec
from dip_benchmark_tpu.models.pipeline import make_fused_pipeline_pallas
from dip_benchmark_tpu.utils import image as jax_image
from dip_benchmark_tpu_torch import oracle
from dip_benchmark_tpu_torch.models import pipeline
from dip_benchmark_tpu_torch.ops import OPS, PLAIN, kernels, point, window
from dip_benchmark_tpu_torch.ops.kernels.build import CSRC
from dip_benchmark_tpu_torch.utils.image import (from_jax_planar,
                                                 from_planar_padded,
                                                 make_layout,
                                                 stack_planar_padded,
                                                 to_planar_padded)

SHAPES = [(37, 53), (5, 5), (64, 80)]


def random_image(hw, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, hw + (3,), np.uint8)


def jax_pipeline(planar: np.ndarray, jax_layout, batch: int = 0):
    return np.asarray(make_fused_pipeline_pallas(jax_layout, batch=batch)(
        jax.device_put(planar)))


@pytest.mark.parametrize("hw", SHAPES)
def test_plain_matches_jax_pallas_and_oracle(hw):
    image = random_image(hw, seed=sum(hw))
    jax_layout = jax_image.make_layout(*hw)
    jax_planar = jax_image.to_planar_padded(image, jax_layout)
    want = from_planar_padded(
        from_jax_planar(jax_pipeline(jax_planar, jax_layout), jax_layout),
        make_layout(*hw))

    out = pipeline.fused_pipeline(from_jax_planar(jax_planar, jax_layout))
    got = from_planar_padded(out, make_layout(*hw))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle.fused_pipeline(image))
    np.testing.assert_array_equal(got, jax_oracle.fused_pipeline(image))


def test_batched_plain_matches_jax_batched_pallas():
    hw = (24, 40)
    images = np.stack([random_image(hw, seed=s) for s in (1, 2, 3)])
    jax_layout = jax_image.make_layout(*hw)
    jax_stack = np.stack([jax_image.to_planar_padded(im, jax_layout)
                          for im in images])
    jax_out = from_jax_planar(jax_pipeline(jax_stack, jax_layout, batch=3),
                              jax_layout)
    stack = from_jax_planar(jax_stack, jax_layout)
    assert tuple(stack.shape) == (3,) + make_layout(*hw).shape
    out = pipeline.fused_pipeline(stack)
    layout = make_layout(*hw)
    got = from_planar_padded(out, layout)
    np.testing.assert_array_equal(got, from_planar_padded(jax_out, layout))
    for b in range(3):
        np.testing.assert_array_equal(got[b], oracle.fused_pipeline(images[b]))
        # A batch is its images, one by one.
        assert torch.equal(out[b], pipeline.fused_pipeline(stack[b]))


@pytest.mark.parametrize("hw", SHAPES + [(24, 40)])
def test_whole_buffer_is_the_composition_inside_a_zero_ring(hw):
    layout = make_layout(*hw)
    planar = to_planar_padded(random_image(hw, seed=7), layout)
    out = pipeline.fused_pipeline_plain(planar)
    assert out.shape == planar.shape and out.dtype == torch.uint8
    r = pipeline.RING
    ring = torch.ones_like(out, dtype=torch.bool)
    ring[:, r:-r, r:-r] = False
    assert not bool(out[ring].any())
    # Rows and columns 2 .. -3: the erosion is valid on 1 .. -2, so the
    # plain ops composed give the same values there without any zeroing.
    composed = window.blur3x3_plain(window.erosion_plain(
        point.threshold_plain(point.grayscale_plain(planar)),
        spec.SQUARE_MASK_3X3))
    assert torch.equal(out[:, r:-r, r:-r], composed[:, r:-r, r:-r])
    # The one result goes to all three planes.
    assert torch.equal(out[0], out[1]) and torch.equal(out[0], out[2])


def test_ring_is_the_only_zero_of_a_bright_image(gradient_image):
    # Every pixel > 127 in every channel: the mask is all 255 inside.
    image = 255 - gradient_image // 2
    layout = make_layout(*image.shape[:2])
    out = pipeline.fused_pipeline_plain(to_planar_padded(image, layout))
    r = pipeline.RING
    assert bool((out[:, r:-r, r:-r] == 255).all())
    assert int(out.sum()) == 255 * out[:, r:-r, r:-r].numel()


def test_threshold_boundary():
    # Gray 127 -> 0 and 128 -> 255 (spec: out = 255 if in > 127), on flat
    # images, whose luma is the value itself.
    for value, want in ((127, 0), (128, 255)):
        image = np.full((9, 11, 3), value, np.uint8)
        layout = make_layout(9, 11)
        out = pipeline.fused_pipeline(to_planar_padded(image, layout))
        assert (from_planar_padded(out, layout) == want).all()


def test_pipeline_is_registered_like_the_jax_package():
    image = random_image((37, 53), seed=9)
    layout = make_layout(37, 53)
    planar = to_planar_padded(image, layout)
    for fn in (OPS["Fused-Pipeline"], PLAIN["Fused-Pipeline"]):
        np.testing.assert_array_equal(from_planar_padded(fn(planar), layout),
                                      oracle.IMAGE_OPS["Fused-Pipeline"](image))


def test_kernel_constants_equal_the_spec():
    # pipeline.cu compiles the spec's numbers in; hold each line to it.
    with open(os.path.join(CSRC, "pipeline.cu")) as f:
        src = f.read()
    consts = {m[0]: int(m[1])
              for m in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (consts["kLumaR"], consts["kLumaG"], consts["kLumaB"]) == tuple(
        spec.GRAYSCALE_WEIGHTS_INT_RGB)
    assert consts["kLumaShift"] == spec.GRAYSCALE_SHIFT
    assert consts["kThreshold"] == spec.THRESHOLD_VALUE
    assert consts["kThresholdMax"] == spec.THRESHOLD_MAX
    assert consts["kRing"] == pipeline.RING
    assert consts["kTileW"] % 4 == 0
    assert consts["kTileW"] == 128 * consts["kPipeWords"]


def _luma_split():
    """The luma weights as pipeline.cu splits them: (hi, lo) with weight =
    256 hi + lo, both below 256."""
    return [(w >> 8, w & 255) for w in spec.GRAYSCALE_WEIGHTS_INT_RGB]


def test_kernel_threshold_on_fields_is_the_spec_threshold():
    # pipeline.cu tests luma > 127 as bit 15 of H + (L >> 8), H and L the
    # weight halves' dot products with the pixel; every pixel of R, G on
    # four B levels, and every B on four R, G levels.
    (hr, lr), (hg, lg), (hb, lb) = _luma_split()
    v = np.arange(256)
    for r, g, b in ((v[:, None, None], v[None, :, None],
                     np.array([0, 1, 128, 255])[None, None, :]),
                    (np.array([0, 1, 128, 255])[:, None, None],
                     np.array([0, 77, 200, 255])[None, :, None],
                     v[None, None, :])):
        h = hr * r + hg * g + hb * b
        lo = lr * r + lg * g + lb * b
        assert h.max() < 1 << 16 and lo.max() < 1 << 16  # a field each
        t = h + (lo >> 8)
        assert t.max() < 1 << 16
        luma = (spec.GRAYSCALE_WEIGHTS_INT_RGB[0] * r
                + spec.GRAYSCALE_WEIGHTS_INT_RGB[1] * g
                + spec.GRAYSCALE_WEIGHTS_INT_RGB[2] * b) >> spec.GRAYSCALE_SHIFT
        np.testing.assert_array_equal((t >> 15) & 1,
                                      luma > spec.THRESHOLD_VALUE)


def test_kernel_blur_map_is_the_rounded_blur():
    # pipeline.cu maps the 1-2-1 x 1-2-1 count k of eroded bytes (each
    # THRESHOLD_MAX or 0) to 16 k, less 1 for k >= 9, four bytes a word.
    k = np.arange(17, dtype=np.uint32)
    words = k * 0x01010101
    f = ((words + 0x07070707) >> 4) & 0x01010101
    got = ((words - f) << 4) | (f * 0x0F)
    want = (spec.THRESHOLD_MAX * k + 8) >> 4
    np.testing.assert_array_equal(got, want * 0x01010101)


def test_cpu_pipeline_launches_no_kernel():
    stack = stack_planar_padded(
        np.stack([random_image((9, 11), seed=s) for s in (1, 2)]),
        make_layout(9, 11))
    kernels.reset_launches()
    pipeline.fused_pipeline(stack)
    pipeline.fused_pipeline(stack[0])
    assert kernels.LAUNCHES == {}


@pytest.mark.parametrize("bad", [
    torch.zeros((1, 9, 16), dtype=torch.uint8),       # one plane
    torch.zeros((2, 1, 9, 16), dtype=torch.uint8),    # one plane a stack
    torch.zeros((2, 2, 3, 9, 16), dtype=torch.uint8),  # 5-D
    torch.zeros((3, 9, 16), dtype=torch.int16),
    torch.zeros((3, 9, 32), dtype=torch.uint8)[..., ::2],
])
def test_wrapper_checks_its_input(bad):
    with pytest.raises(ValueError):
        pipeline.fused_pipeline(bad)


def test_wrapper_refuses_other_devices():
    planar = torch.empty((2, 3, 9, 16), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="meta"):
        pipeline.fused_pipeline(planar)


@pytest.mark.cuda
@pytest.mark.parametrize("hw", SHAPES + [(128, 256)])
def test_kernel_matches_plain_on_card(hw):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    image = random_image(hw, seed=11)
    layout = make_layout(*hw)
    planar = to_planar_padded(image, layout).cuda()
    got = pipeline.fused_pipeline(planar)
    torch.cuda.synchronize()
    assert got.is_cuda
    assert torch.equal(got, pipeline.fused_pipeline_plain(planar))
    np.testing.assert_array_equal(from_planar_padded(got, layout),
                                  oracle.fused_pipeline(image))


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(37, 53), (130, 300)])
def test_batched_kernel_matches_plain_on_card(hw):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    images = np.stack([random_image(hw, seed=s) for s in (12, 13, 14)])
    layout = make_layout(*hw)
    stack = stack_planar_padded(images, layout).cuda()
    kernels.reset_launches()
    got = pipeline.fused_pipeline(stack)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"pipeline_u8": 1}
    assert torch.equal(got, pipeline.fused_pipeline_plain(stack))
    crops = from_planar_padded(got, layout)
    for b in range(3):
        np.testing.assert_array_equal(crops[b],
                                      oracle.fused_pipeline(images[b]))


@pytest.mark.cuda
def test_kernel_matches_plain_on_card_at_edges():
    # chip_smoke.py phase 3j: rows that end at or past a lane's words or a
    # warp's span, heights not a multiple of the strip, raw buffers; alone
    # and on stacks of 1, 2 and 3.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    import chip_smoke
    assert chip_smoke.compare_pipeline_edges(np.random.default_rng(15)) == 0
