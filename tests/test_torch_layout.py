"""The port's planar layout: round trip, baked mirror halo, pitch, the
carry-across of the JAX package's planar buffer (from_jax_planar), and the
plain bake and crop of a stack (ops/layout.py) against the host's; the
card's bake and crop are held to the host's in tests/test_torch_bake.py
and tests/test_torch_crop.py."""

import numpy as np
import pytest
import torch

from dip_benchmark_tpu.utils import image as jax_image
from dip_benchmark_tpu_torch import oracle
from dip_benchmark_tpu_torch.models import batch, chain
from dip_benchmark_tpu_torch.ops import kernels
from dip_benchmark_tpu_torch.ops.layout import (bake_stack, bake_stack_plain,
                                                crop_stack, crop_stack_plain)
from dip_benchmark_tpu_torch.runtime import tracing
from dip_benchmark_tpu_torch.utils.image import (PITCH_ALIGN, from_jax_planar,
                                                 from_planar_padded,
                                                 make_layout,
                                                 stack_planar_padded,
                                                 to_planar_padded,
                                                 to_planar_padded_f32)
from test_torch_bake import BAKE_CASES, bake_case
from test_torch_crop import CHAIN8, CROP_CASES, planar_case

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


@pytest.mark.parametrize("pad", [4, 2, 0])
def test_from_jax_planar_recuts_a_deeper_halo(pad, small_image):
    # A chain of radius 4 runs on a JAX bake with halo=4; the port's window
    # of any pad up to that halo is its own bake with that pad.
    h, w = small_image.shape[:2]
    jax_layout = jax_image.make_layout(h, w, halo=4)
    jax_planar = jax_image.to_planar_padded(small_image, jax_layout)
    recut = from_jax_planar(jax_planar, jax_layout, pad=pad)
    assert torch.equal(recut, to_planar_padded(small_image,
                                               make_layout(h, w, pad=pad)))
    scaled = from_jax_planar(jax_image.to_planar_padded_f32(
        small_image, jax_layout), jax_layout, pad=pad)
    assert torch.equal(scaled, to_planar_padded_f32(
        small_image, make_layout(h, w, pad=pad)))


def test_from_jax_planar_refuses_a_pad_beyond_the_jax_halo(small_image):
    jax_layout = jax_image.make_layout(*small_image.shape[:2], halo=4)
    arr = jax_image.to_planar_padded(small_image, jax_layout)
    with pytest.raises(ValueError, match="cannot hold"):
        from_jax_planar(arr, jax_layout, pad=5)


def test_from_jax_planar_takes_a_batch_axis(small_image, rng):
    h, w = small_image.shape[:2]
    images = np.stack([small_image, 255 - small_image,
                       rng.integers(0, 256, small_image.shape, np.uint8)])
    jax_layout = jax_image.make_layout(h, w)
    jax_stack = np.stack([jax_image.to_planar_padded(im, jax_layout)
                          for im in images])
    recut = from_jax_planar(jax_stack, jax_layout)
    layout = make_layout(h, w)
    assert recut.is_contiguous() and tuple(recut.shape) == (3,) + layout.shape
    for b in range(3):
        assert bool((recut[b] == from_jax_planar(jax_stack[b],
                                                 jax_layout)).all())
    assert bool((recut == stack_planar_padded(images, layout)).all())
    np.testing.assert_array_equal(from_planar_padded(recut, layout), images)


def test_from_jax_planar_refuses_other_ranks(small_image):
    jax_layout = jax_image.make_layout(*small_image.shape[:2])
    arr = jax_image.to_planar_padded(small_image, jax_layout)
    for bad in (arr[0], arr[None, None]):
        with pytest.raises(ValueError, match="expected"):
            from_jax_planar(bad, jax_layout)


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


# -- the batch tool's bake of a stack (ops/layout.py) -----------------------

def test_bake_cases_cover_the_slack_and_the_sides():
    slacks = {make_layout(h, w, pad=pad).pitch - w - 2 * pad
              for _, h, w, pad in BAKE_CASES}
    assert {0, 15} <= slacks
    assert {b for b, *_ in BAKE_CASES} == {1, 2, 3}
    assert all((h, w) == (pad + 1, pad + 1)
               for _, h, w, pad in BAKE_CASES[::4])


@pytest.mark.parametrize("b,h,w,pad", BAKE_CASES)
def test_bake_stack_plain_is_the_host_bake(b, h, w, pad):
    images, layout = bake_case(b, h, w, pad)
    got = bake_stack_plain(torch.from_numpy(images), layout)
    assert got.is_contiguous() and got.dtype == torch.uint8
    assert torch.equal(got, stack_planar_padded(images, layout))
    kernels.reset_launches()
    assert torch.equal(bake_stack(torch.from_numpy(images), layout), got)
    assert kernels.LAUNCHES == {}


def _bad_stacks():
    ok = torch.zeros((2, 9, 12, 3), dtype=torch.uint8)
    layout = make_layout(9, 12)
    return {
        "dtype": (ok.to(torch.int32), layout),
        "rank": (ok[0], layout),
        "channels": (torch.zeros((2, 9, 12, 4), dtype=torch.uint8), layout),
        "layout channels": (ok, make_layout(9, 12, channels=1)),
        "contiguity": (torch.zeros((2, 9, 24, 3), dtype=torch.uint8)
                       [:, :, ::2], layout),
        "height": (ok, make_layout(10, 12)),
        "width": (ok, make_layout(9, 13)),
        "empty": (ok[:0], layout),
        "device": (torch.zeros((2, 9, 12, 3), dtype=torch.uint8,
                               device="meta"), layout),
    }


@pytest.mark.parametrize("case", sorted(_bad_stacks()))
def test_bake_stack_refuses(case):
    stack, layout = _bad_stacks()[case]
    with pytest.raises(ValueError):
        bake_stack(stack, layout)


def test_cpu_batch_bakes_on_the_host_and_launches_nothing():
    images, _ = bake_case(3, 24, 40, 2)
    kernels.reset_launches()
    tracing.enable()
    try:
        got = batch.process_batch(images, device="cpu")
        snap = tracing.snapshot()
    finally:
        tracing.disable()
    assert kernels.LAUNCHES == {}
    assert "card_bakes" not in snap.counters
    assert "card_crops" not in snap.counters
    assert snap.counters["images"] == 3
    for i in range(3):
        np.testing.assert_array_equal(got[i], oracle.fused_pipeline(images[i]))


@pytest.mark.parametrize("cols", ["Fused-Pipeline", CHAIN8])
def test_cpu_batch_goes_through_the_layout_wrappers(cols, monkeypatch):
    # The CPU batch takes the card's route: one bake_stack and one
    # crop_stack a batch, whose plain versions do the work.
    images, _ = bake_case(2, 24, 40, 8)
    calls = []
    for name in ("bake_stack", "crop_stack"):
        monkeypatch.setattr(batch, name, lambda planar, layout, name=name,
                            real=getattr(batch, name): (
            calls.append(name), real(planar, layout))[1])
    op = cols if isinstance(cols, str) else list(cols)
    got = batch.process_batch(images, op, device="cpu")
    assert calls == ["bake_stack", "crop_stack"]
    want = (oracle.fused_pipeline if isinstance(cols, str)
            else chain.chain_row_parts(op)[2])
    for i in range(2):
        np.testing.assert_array_equal(got[i], want(images[i]))


# -- the batch tool's crop of a planar stack (ops/layout.py) -----------------

def test_crop_cases_add_a_chain_layout_of_pad_8():
    assert max(2, *chain.check_chain(CHAIN8)) == 8
    assert CROP_CASES[:len(BAKE_CASES)] == BAKE_CASES
    assert {pad for *_, pad in CROP_CASES[len(BAKE_CASES):]} == {8}


@pytest.mark.parametrize("b,h,w,pad", CROP_CASES)
def test_crop_stack_plain_is_the_host_crop(b, h, w, pad):
    planar, layout = planar_case(b, h, w, pad)
    got = crop_stack_plain(planar, layout)
    assert got.is_contiguous() and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(),
                                  from_planar_padded(planar, layout))
    images, _ = bake_case(b, h, w, pad)
    assert torch.equal(crop_stack_plain(
        bake_stack_plain(torch.from_numpy(images), layout), layout),
        torch.from_numpy(images))


def test_crop_stack_on_the_cpu_is_the_plain_crop_and_counts_nothing():
    planar, layout = planar_case(2, 37, 53, 3)
    kernels.reset_launches()
    tracing.enable()
    try:
        got = crop_stack(planar, layout)
        snap = tracing.snapshot()
    finally:
        tracing.disable()
    assert kernels.LAUNCHES == {}
    assert "card_crops" not in snap.counters and "alloc" not in snap.spans
    assert torch.equal(got, crop_stack_plain(planar, layout))


def _bad_planar_stacks():
    layout = make_layout(9, 12)
    ok = torch.zeros((2,) + layout.shape, dtype=torch.uint8)
    wide = torch.zeros((2, 3, layout.padded_height, 2 * layout.pitch),
                       dtype=torch.uint8)
    return {
        "dtype": (ok.to(torch.int32), layout),
        "rank": (ok[0], layout),
        "planes": (torch.zeros((2, 4) + layout.shape[1:], dtype=torch.uint8),
                   make_layout(9, 12, channels=4)),
        "layout channels": (ok[:, :1].contiguous(),
                            make_layout(9, 12, channels=1)),
        "contiguity": (wide[..., ::2], layout),
        "height": (ok, make_layout(10, 12)),
        "pitch": (ok, make_layout(9, 30)),
        "pad": (ok, make_layout(9, 12, pad=3)),
        "empty": (ok[:0], layout),
        "device": (torch.zeros((2,) + layout.shape, dtype=torch.uint8,
                               device="meta"), layout),
    }


@pytest.mark.parametrize("case", sorted(_bad_planar_stacks()))
def test_crop_stack_refuses(case):
    planar, layout = _bad_planar_stacks()[case]
    with pytest.raises(ValueError):
        crop_stack(planar, layout)


def test_cpu_batch_of_a_pad_8_chain_crops_on_the_host():
    images, _ = bake_case(2, 24, 40, 8)
    kernels.reset_launches()
    tracing.enable()
    try:
        got = batch.process_batch(images, list(CHAIN8), device="cpu")
        snap = tracing.snapshot()
    finally:
        tracing.disable()
    assert kernels.LAUNCHES == {}
    assert "card_crops" not in snap.counters and snap.spans["crop"][0] == 1
    seq = chain.chain_row_parts(list(CHAIN8))[2]
    for i in range(2):
        np.testing.assert_array_equal(got[i], seq(images[i]))
