"""Every mask shape of the JAX package's convolutions, in both data models.

The JAX builders take any dense mask whose half-sizes fit the layout's halo
(at most 8, so 1 to 17 taps a side, even and non-square included), any
separable N with N // 2 within it, and an ``acc_dtype`` that routes a mask
to the dense body. These tests hold the port's builders
(``window.make_convolution``, ``window.make_convolution_separated_fused``,
``f32.make_conv``, ``f32.make_conv_sep``) and its bare-tensor functions, on
their plain versions, to the JAX kernels in Pallas interpret mode, on
seeded 24x40 images baked on halo-8 layouts: the JAX bake is carried across
with ``from_jax_planar`` (and is the port's own ``to_planar_padded``), and
the two are compared on the crop.

Tolerance: uint8 0 (both are exact integer arithmetic, the int32 wrap on
overflow included). float32: a dense kh x kw mask of weights w within
``kh * kw * 2**-24 * sum(|w|)``, and a separable pair within ``2 N *
2**-24 * sum(|wr|) * sum(|wc|)``, on values in [0, 1]: the interpret run
may contract a multiply-add into an FMA, which skips one rounding of a
product, so each term may differ by an ulp of its size.

The card-only tests at the end hold each kernel of ``csrc/conv.cu`` to its
plain version at tolerance 0; they skip without a CUDA device.
"""

import os
import re

import numpy as np
import pytest
import torch

from dip_benchmark_tpu_torch import spec
from dip_benchmark_tpu_torch.ops import f32, kernels, window
from dip_benchmark_tpu_torch.utils.image import (from_jax_planar,
                                                 make_layout,
                                                 to_planar_padded,
                                                 to_planar_padded_f32)

try:
    import jax.numpy as jnp

    from dip_benchmark_tpu.ops.pallas import f32 as jax_f32
    from dip_benchmark_tpu.ops.pallas import window as jax_window
    from dip_benchmark_tpu.utils import image as jax_image
except ImportError:   # a machine with a card and no JAX runs the card tests
    jnp = jax_f32 = jax_window = jax_image = None

H, W, PAD = 24, 40, 8
DENSE_SHAPES = [(1, 1), (1, 3), (3, 1), (3, 5), (5, 3), (2, 4), (7, 5),
                (7, 7), (9, 9), (1, 17), (17, 1), (17, 17)]
SEP_NS = list(range(1, 18))   # every N the JAX builders take, even ones too
RANK1_SHAPES = [(1, 3), (3, 5), (2, 4), (7, 5), (9, 9), (1, 17), (17, 17)]
TILE = ("conv_tile_dense_u8", "conv_tile_dense_mma_u8",
        "conv_tile_two_pass_u8")


@pytest.fixture(autouse=True)
def _needs_jax(request):
    if jax_window is None and request.node.get_closest_marker("cuda") is None:
        pytest.skip("compares with the JAX package, which is not installed")


def image(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (H, W, 3), np.uint8)


def jax_layout(itemsize: int = 1):
    return jax_image.make_layout(H, W, halo=PAD, itemsize=itemsize)


def crop(planar: np.ndarray, lay) -> np.ndarray:
    """The (C, H, W) image region of a JAX or port planar."""
    py = getattr(lay, "pad_y", None) or lay.pad
    px = getattr(lay, "pad_x", None) or lay.pad
    return np.asarray(planar)[:, py:py + H, px:px + W]


def run_u8(jax_build, port_build, img: np.ndarray):
    """(JAX crop, port crop) of one uint8 op on ``img``: the JAX op on its
    halo-8 bake, the port's on the same bake carried across."""
    jl = jax_layout()
    bake = jax_image.to_planar_padded(img, jl)
    want = crop(jax_build(jl)(bake), jl)
    layout = make_layout(H, W, pad=PAD)
    planar = from_jax_planar(bake, jl, pad=PAD)
    got = port_build(layout)(planar)
    return want, crop(got.numpy(), layout)


def run_f32(jax_build, port_build, img: np.ndarray):
    jl = jax_layout(itemsize=4)
    bake = jax_image.to_planar_padded_f32(img, jl)
    want = crop(jax_build(jl)(bake), jl)
    layout = make_layout(H, W, pad=PAD)
    got = port_build(layout)(from_jax_planar(bake, jl, pad=PAD))
    return want, crop(got.numpy(), layout)


def random_mask(rng, kh: int, kw: int) -> np.ndarray:
    """Weights of either sign: the dense form, clamping at both ends."""
    return rng.integers(-40, 90, (kh, kw)).astype(np.int32)


def rank1_mask(rng, kh: int, kw: int) -> np.ndarray:
    """A nonnegative outer product within the packed-16 bound: the JAX
    package's body_rank1."""
    while True:
        u = rng.integers(0, 3, kh)
        v = rng.integers(0, 3, kw)
        u[kh // 2] += 1
        v[kw // 2] += 1
        m = np.outer(u, v).astype(np.int32)
        if 255 * int(m.sum()) < 1 << 16:
            return m


def test_port_bake_equals_jax_bake_on_halo_8():
    jl = jax_layout()
    img = image(0)
    carried = from_jax_planar(jax_image.to_planar_padded(img, jl), jl,
                              pad=PAD)
    assert torch.equal(carried, to_planar_padded(img, make_layout(
        H, W, pad=PAD)))


# -- uint8 --------------------------------------------------------------------

@pytest.mark.parametrize("kh,kw", DENSE_SHAPES)
def test_dense_u8_matches_jax(kh, kw):
    rng = np.random.default_rng(100 * kh + kw)
    mask, shift = random_mask(rng, kh, kw), int(rng.integers(3, 9))
    want, got = run_u8(
        lambda jl: jax_window.make_convolution(jl, kh, kw, shift, mask),
        lambda lay: window.make_convolution(lay, kh, kw, shift, mask),
        image(kh * kw))
    np.testing.assert_array_equal(got, want)
    if (kh, kw) not in ((3, 3), (5, 5)):
        assert window.convolution_launch(mask, shift)[0] in TILE


@pytest.mark.parametrize("kh,kw", RANK1_SHAPES)
def test_factoring_u8_matches_jax_and_routes_rank1(kh, kw, monkeypatch):
    rng = np.random.default_rng(7 * kh + kw)
    mask = rank1_mask(rng, kh, kw)
    shift = int(rng.integers(1, 9))
    assert jax_body(mask, shift, monkeypatch) == "body_rank1"
    assert window.convolution_launch(mask, shift)[0] == (
        "conv_tile_two_pass_u8")
    want, got = run_u8(
        lambda jl: jax_window.make_convolution(jl, kh, kw, shift, mask),
        lambda lay: window.make_convolution(lay, kh, kw, shift, mask),
        image(kh + kw))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", SEP_NS)
def test_separable_u8_matches_jax(n):
    # Odd n: weights of either sign (body_i32); even n: packable weights
    # (body_packed), so both JAX bodies are met across the N.
    rng = np.random.default_rng(n)
    low = -6 if n % 2 else 0
    row = rng.integers(low, 9, (1, n)).astype(np.int32)
    row[0, n // 2] += 1
    shift = int(rng.integers(2, 6))
    want, got = run_u8(
        lambda jl: jax_window.make_convolution_separated_fused(
            jl, n, row, shift),
        lambda lay: window.make_convolution_separated_fused(
            lay, n, row, shift), image(50 + n))
    np.testing.assert_array_equal(got, want)
    name = window.convolution_separated_launch(row, row.T.copy(), shift)[0]
    assert name == (f"window_u8<ConvSep<{n}>>" if n in (3, 5)
                    else "conv_tile_two_pass_u8")


def jax_acc_dtype(name: str):
    return {"int16": jnp.int16, "int32": jnp.int32}[name]


@pytest.mark.parametrize("acc", ["int16", "int32"])
@pytest.mark.parametrize("kind", ["random", "factoring"])
def test_acc_dtype_takes_the_dense_form_and_matches_jax(acc, kind):
    rng = np.random.default_rng(3)
    mask = (random_mask(rng, 7, 5) if kind == "random"
            else rank1_mask(rng, 7, 5))
    want, got = run_u8(
        lambda jl: jax_window.make_convolution(
            jl, 7, 5, 6, mask, acc_dtype=jax_acc_dtype(acc)),
        lambda lay: window.make_convolution(lay, 7, 5, 6, mask,
                                            acc_dtype=acc), image(9))
    np.testing.assert_array_equal(got, want)
    # The dense form; its weights fit int8, so the tensor-core body.
    assert window.convolution_launch(mask, 6, acc)[0] == (
        "conv_tile_dense_mma_u8")


def test_acc_dtype_keeps_3x3_on_the_dense_strip_body():
    # The matrix's Gaussian factors; an acc_dtype sends it to ConvDense, as
    # make_convolution sends it to body_i32.
    assert window.convolution_launch(spec.BLUR_3X3_INT, 4, "int32")[0] == (
        "window_u8<ConvDense<3,3>>")
    assert window.convolution_launch(spec.BLUR_3X3_INT, 4)[0] == (
        "window_u8<ConvRank1<3,3>>")


# Masks whose int32 sums wrap: (label, mask, shift). The JAX quantizer
# clamps the first two (a negative weight); the third, all nonnegative and
# shifted by 31, it does not clamp, so the wrapped sum's low byte is the
# output.
OVERFLOW = [
    ("5x5 of either sign", np.where(
        np.arange(25).reshape(5, 5) % 3, 1 << 24, -(1 << 23)), 4),
    ("7x3 of either sign", np.full((7, 3), 3 << 22) * np.array(
        [1, -1, 1])[None, :], 20),
    ("9x9 nonnegative, shift 31", np.full((9, 9), 1 << 23), 31),
]


@pytest.mark.parametrize("case", range(len(OVERFLOW)))
def test_overflowing_mask_wraps_as_jax_does(case):
    label, mask, shift = OVERFLOW[case]
    mask = mask.astype(np.int32)
    kh, kw = mask.shape
    assert window.wraps(mask, shift), label
    assert window.clamps(mask, shift) == (case < 2)
    want, got = run_u8(
        lambda jl: jax_window.make_convolution(jl, kh, kw, shift, mask),
        lambda lay: window.make_convolution(lay, kh, kw, shift, mask),
        image(70 + case))
    np.testing.assert_array_equal(got, want)
    # Even at 3x3 a wrapping mask leaves the strip body for the tile one.
    assert window.convolution_launch(mask, shift)[0] == "conv_tile_dense_u8"


def test_overflowing_separable_mask_wraps_as_jax_does():
    row = np.array([[1 << 22, -(1 << 22), 3 << 21, 5, -(1 << 21)]], np.int32)
    want, got = run_u8(
        lambda jl: jax_window.make_convolution_separated_fused(jl, 5, row,
                                                               3),
        lambda lay: window.make_convolution_separated_fused(lay, 5, row, 3),
        image(80))
    np.testing.assert_array_equal(got, want)
    assert window.convolution_separated_launch(row, row.T.copy(), 3)[0] == (
        "conv_tile_two_pass_u8")


@pytest.mark.parametrize("kh,kw", [(2, 4), (7, 5), (17, 1)])
def test_bare_convolution_equals_the_builder(kh, kw):
    rng = np.random.default_rng(kh * kw)
    mask = random_mask(rng, kh, kw)
    layout = make_layout(H, W, pad=PAD)
    planar = to_planar_padded(image(1), layout)
    assert torch.equal(window.convolution(planar, mask, 5),
                       window.make_convolution(layout, kh, kw, 5,
                                               mask)(planar))


@pytest.mark.parametrize("kh,kw", [(2, 4), (4, 1), (7, 5), (6, 6), (1, 17)])
def test_rank1_plain_equals_dense_at_any_anchor(kh, kw):
    rng = np.random.default_rng(kh + 10 * kw)
    mask = rank1_mask(rng, kh, kw)
    u, v = window.factor_rank1_int(mask)
    planar = torch.from_numpy(rng.integers(0, 256, (2, 21, 48), np.uint8))
    assert torch.equal(window.conv_rank1_plain(planar, u, v, 4),
                       window.conv_dense_plain(planar, mask, 4))


# -- the dense form's two bodies -----------------------------------------------

def wide_mask(rng, kh: int, kw: int, big: int) -> np.ndarray:
    """Weights of either sign with one of ``big`` (outside int8) at the
    anchor: the IMAD body, its int32 sums far from wrapping."""
    m = random_mask(rng, kh, kw)
    m[kh // 2, kw // 2] = big
    return m


# (label, mask, shift, acc_dtype, the dense form's kernel)
_R = np.random.default_rng(11)
BODY_CASES = [
    ("int8 7x5", random_mask(_R, 7, 5), 6, None, "conv_tile_dense_mma_u8"),
    ("int8 ends 1x17", np.array([[-128, 127] * 8 + [5]]), 7, None,
     "conv_tile_dense_mma_u8"),
    ("int8 2x4", random_mask(_R, 2, 4), 4, None, "conv_tile_dense_mma_u8"),
    ("+200 7x7", wide_mask(_R, 7, 7, 200), 8, None, "conv_tile_dense_u8"),
    ("-200 17x17", wide_mask(_R, 17, 17, -200), 9, None,
     "conv_tile_dense_u8"),
    ("128 1x17", wide_mask(_R, 1, 17, 128), 7, None, "conv_tile_dense_u8"),
    ("-129 9x1", wide_mask(_R, 9, 1, -129), 7, None, "conv_tile_dense_u8"),
    ("int8 7x5, acc int32", random_mask(_R, 7, 5), 6, "int32",
     "conv_tile_dense_mma_u8"),
    ("int8 rank 1 7x5, acc int16", rank1_mask(_R, 7, 5), 6, "int16",
     "conv_tile_dense_mma_u8"),
    ("+200 7x5, acc int32", wide_mask(_R, 7, 5, 200), 8, "int32",
     "conv_tile_dense_u8"),
    ("+200 3x3 keeps the strip body", wide_mask(_R, 3, 3, 200), 8, None,
     "window_u8<ConvDense<3,3>>"),
] + [(f"overflow {label}", mask.astype(np.int32), shift, None,
      "conv_tile_dense_u8") for label, mask, shift in OVERFLOW]


@pytest.mark.parametrize("case", range(len(BODY_CASES)))
def test_dense_form_takes_the_body_its_weights_fit(case):
    label, mask, shift, acc, want = BODY_CASES[case]
    assert window.convolution_launch(mask, shift, acc)[0] == want, label
    assert window.fits_int8(mask) == (want == "conv_tile_dense_mma_u8") or (
        want.startswith("window_u8")), label


@pytest.mark.parametrize("kh,kw", [(7, 7), (1, 17), (17, 17), (2, 9)])
def test_dense_u8_outside_int8_matches_jax(kh, kw):
    rng = np.random.default_rng(500 + 20 * kh + kw)
    mask, shift = wide_mask(rng, kh, kw, -200 if kh % 2 else 300), 9
    assert window.convolution_launch(mask, shift)[0] == "conv_tile_dense_u8"
    want, got = run_u8(
        lambda jl: jax_window.make_convolution(jl, kh, kw, shift, mask),
        lambda lay: window.make_convolution(lay, kh, kw, shift, mask),
        image(kh + 3 * kw))
    np.testing.assert_array_equal(got, want)


def mma_band(win_row: np.ndarray) -> np.ndarray:
    """The 16 x 32 int8 A operand the lanes of conv_tile_dense_mma_u8
    assemble from one mask row's windows: lane (g, t) holds, in register
    j, row g + 8 (j % 2), columns 4 t + 16 (j // 2) .. + 3, the mma.sync
    m16n8k32 fragment layout of A."""
    a = np.full((16, 32), 999, np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for j in range(4):
            word = int(win_row[4 * t + 16 * (j >> 1) - g - 8 * (j & 1) + 15])
            m, k0 = g + 8 * (j & 1), 4 * t + 16 * (j >> 1)
            for b in range(4):
                byte = (word >> (8 * b)) & 0xFF
                a[m, k0 + b] = byte - 256 if byte > 127 else byte
    return a


def emulate_mma(planar: np.ndarray, mask: np.ndarray,
                shift: int) -> np.ndarray:
    """conv_tile_dense_mma_u8's output from the host's windows: for each
    group of 16 output columns and mask row ky, the band A times B, B the
    32 frame bytes from 8 columns left of the group of each output row's
    row + ky - kh // 2 (0 off the buffer); then the quantizer and the
    ring."""
    kh, kw = mask.shape
    hy, hx = kh // 2, kw // 2
    c, hp, pitch = planar.shape
    frame = np.zeros((c, hp + kh, pitch + 32), np.int64)
    frame[:, hy:hy + hp, 8:8 + pitch] = planar
    acc = np.zeros((c, hp, pitch), np.int64)
    win = window.mma_windows(mask)
    for ky in range(kh):
        band = mma_band(win[ky])
        rows = frame[:, ky:ky + hp]   # output row y reads y - hy + ky
        for xg in range(0, pitch, 16):
            acc[:, :, xg:xg + 16] += rows[:, :, xg:xg + 32] @ band.T
    out = window._round(torch.from_numpy(acc), shift,
                        window.clamps(mask, shift))
    return window.zero_ring(out.to(torch.uint8), hy, hx).numpy()


@pytest.mark.parametrize("kh,kw", [(1, 1), (1, 17), (17, 1), (2, 4),
                                   (4, 2), (7, 7), (6, 16), (17, 17)])
def test_mma_band_is_the_toeplitz_of_each_mask_row(kh, kw):
    rng = np.random.default_rng(kh * 31 + kw)
    mask = rng.integers(-128, 128, (kh, kw))
    win = window.mma_windows(mask)
    assert win.shape == (kh, window.MMA_WINDOWS) and win.dtype == np.uint32
    m, k = np.meshgrid(np.arange(16), np.arange(32), indexing="ij")
    kx = k - m - 8 + kw // 2
    for ky in range(kh):
        want = np.where((kx >= 0) & (kx < kw),
                        mask[ky, np.clip(kx, 0, kw - 1)], 0)
        np.testing.assert_array_equal(mma_band(win[ky]), want)


@pytest.mark.parametrize("kh,kw,shift", [(1, 17, 7), (17, 1, 6), (2, 9, 5),
                                         (7, 7, 8), (8, 3, 4), (17, 17, 12),
                                         (9, 6, 31)])
def test_mma_emulation_equals_conv_dense_plain(kh, kw, shift):
    rng = np.random.default_rng(kh * 17 + kw)
    mask = rng.integers(-128, 128, (kh, kw))
    mask[0, 0], mask[-1, -1] = -128, 127
    planar = rng.integers(0, 256, (2, 37, 48), np.uint8)
    want = window.conv_dense_plain(torch.from_numpy(planar), mask, shift)
    np.testing.assert_array_equal(emulate_mma(planar, mask, shift),
                                  want.numpy())


def two_pass_knobs() -> dict:
    """The two-pass kernels' geometry, read from csrc/conv.cu: the least
    rows a warp walks (the launch picks more on a tall buffer) and the
    columns a warp owns."""
    src = os.path.join(os.path.dirname(window.__file__), "kernels", "csrc",
                       "conv.cu")
    with open(src) as f:
        text = f.read()
    return {"rows": int(re.search(r"kSepMinRows = (\d+);", text).group(1)),
            "cols": int(re.search(r"kSepCols = (\d+);", text).group(1))}


def emulate_two_pass(planar: np.ndarray, u, v, row_pass, col_step,
                     finish, zero, rows=None):
    """The walk of conv.cu's two-pass kernels, tile by tile of ``rows``
    output rows (default: the least a warp walks): frame row j of a tile is plane row y0 - kh // 2 + j (0
    off the buffer), its row pass ``row_pass(values, x)`` for every column
    (the values a whole padded row, the taps from x - kw // 2), then the
    register ring: frame row j completes output row j - kh + 1 (``done``,
    from part[0]) and adds its term with weight u[kh - 2 - k] to part[k],
    which moves to part[k - 1]; ``col_step(acc, q, w)`` adds one term,
    ``col_step(None, q, w)`` starts a sum. ``finish(done)`` is the output;
    the zero ring of kh // 2 rows and kw // 2 columns is ``zero``."""
    kh, kw = len(u), len(v)
    hy, hx = kh // 2, kw // 2
    c, hp, pitch = planar.shape
    rows = rows or two_pass_knobs()["rows"]
    pad = np.zeros((c, hp + 2 * kh + rows, pitch + 2 * PAD + 24),
                   planar.dtype)
    pad[:, kh:kh + hp, 2 * PAD:2 * PAD + pitch] = planar
    out = np.zeros((c, hp, pitch), np.float64)
    for y0 in range(0, hp, rows):
        parts = [None] * (kh - 1)
        for j in range(rows + kh - 1):
            y = y0 - hy + j
            q = row_pass(pad[:, kh + y], 2 * PAD - hx)
            done = col_step(parts[0] if kh > 1 else None, q, u[kh - 1])
            parts = [col_step(parts[k + 1], q, u[kh - 2 - k])
                     for k in range(kh - 2)] + (
                [col_step(None, q, u[0])] if kh > 1 else [])
            o = j - (kh - 1)
            if 0 <= o < rows and y0 + o < hp:
                out[:, y0 + o] = finish(done)
    out[:, :hy], out[:, hp - hy:] = zero, zero
    out[..., :hx], out[..., pitch - hx:] = zero, zero
    return out


def weight_digits(w: int) -> list:
    """The balanced base-256 digits conv.cu's host code splits a row
    weight into: the low byte as a signed one, then (w - d) / 256, modulo
    2^32, until nothing is left (at most 4)."""
    w &= 0xFFFFFFFF
    out = []
    while w and len(out) < 4:
        d = (w & 255) - (256 if w & 128 else 0)
        out.append(d)
        w = ((w - d) & 0xFFFFFFFF) >> 8
    return out


def emulate_two_pass_u8(planar, u, v, shift, round_between, clamp_rows,
                        clamp_out):
    """conv_tile_two_pass_u8: the row pass as dp4a products of frame bytes
    and the weights' base-256 digits over whole groups of 4 taps (kw taps
    from the anchor kw // 2 where kw == kh, else 17 with the weights at
    the anchor 8), each digit's sum shifted by 8 bits a digit, uint32
    sums; (acc + half) >> shift arithmetic, clamped by the flags."""
    kh, kw = len(u), len(v)
    side = kw if kw == kh else window.MAX_CONV_SIDE
    first = 0 if kw == kh else side // 2 - kw // 2
    taps = 4 * ((side + 3) // 4)
    digits = np.zeros((4, taps), np.int64)
    for t, w in enumerate(v):
        for i, d in enumerate(weight_digits(int(w))):
            digits[i, first + t] = d
    planes = max([len(weight_digits(int(w))) for w in v] + [1])
    half = (1 << shift) >> 1
    pitch = planar.shape[2]

    def quantize(acc, clamp):
        s32 = ((acc + half) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
        q = s32.astype(np.int64) >> shift
        return np.clip(q, 0, 255) if clamp else q

    def row_pass(values, x0):
        x0 -= side // 2 - kw // 2 if kw != kh else 0
        p = 0
        for i in range(planes):
            d = sum(int(digits[i, t]) * values[:, x0 + t:x0 + t + pitch]
                    .astype(np.int64) for t in range(taps))
            p = p + (d << (8 * i))
        p = p & 0xFFFFFFFF
        return quantize(p, clamp_rows) & 0xFFFFFFFF if round_between else p

    def col_step(acc, q, w):
        t = (int(w) * q) & 0xFFFFFFFF
        return t if acc is None else (acc + t) & 0xFFFFFFFF

    return emulate_two_pass(planar, u, v, row_pass, col_step,
                            lambda d: quantize(d, clamp_out) & 255,
                            0).astype(np.uint8)


@pytest.mark.parametrize("w", [0, 1, -1, 127, 128, -128, -129, 200, 12870,
                               1 << 22, -(1 << 22), 1 << 23, (1 << 31) - 1,
                               -(1 << 31)])
def test_weight_digits_are_balanced_and_exact(w):
    digits = weight_digits(w)
    assert all(-128 <= d <= 127 for d in digits) and len(digits) <= 4
    assert (sum(d << (8 * i) for i, d in enumerate(digits)) - w) % (
        1 << 32) == 0


BINOMIAL = {n: np.array([__import__("math").comb(n - 1, k)
                         for k in range(n)]) for n in (9, 17)}
TWO_PASS_BODIES = [
    # (label, u, v, shift, round_between, clamp_rows, body)
    ("binomial 9, rounded", BINOMIAL[9], BINOMIAL[9], 8, True, False,
     (True, 1, True)),
    ("binomial 17, rounded", BINOMIAL[17], BINOMIAL[17], 16, True, False,
     (True, 2, True)),
    ("box 7x7, unrounded", np.ones(7), np.ones(7), 6, False, False,
     (True, 1, True)),
    ("box 1x17, unrounded", np.ones(1), np.ones(17), 4, False, False,
     (False, 1, True)),
    ("either sign 9x3, rounded, clamped", np.array([-6] * 9),
     np.array([8, -6, 8]), 3, True, True, (False, 1, True)),
    ("a row weight of 40000", np.ones(5), np.array([1, 2, 40000, 2, 1]), 8,
     True, True, (True, 4, False)),
    ("column sums past 2^24", np.array([70000, 1, 1]), np.ones(3), 8,
     True, True, (True, 4, False)),
    ("row sums past 2^22 unrounded", np.ones(3), np.array([1, 20000, 1]), 8,
     False, False, (True, 4, False)),
    ("wraps", np.full(5, 1 << 22), np.full(5, 3 << 21), 3, True, True,
     (True, 4, False)),
]


@pytest.mark.parametrize("case", range(len(TWO_PASS_BODIES)))
def test_two_pass_takes_the_body_its_sums_fit(case):
    label, u, v, shift, rnd, clamp_rows, want = TWO_PASS_BODIES[case]
    assert window.two_pass_body(u, v, shift, rnd, clamp_rows) == want, label


@pytest.mark.parametrize("case", range(len(TWO_PASS_BODIES)))
def test_float_column_pass_is_exact_where_chosen(case):
    # Where the float column pass is chosen, every column sum over the
    # worst row values (the bound of each, in either sign) is an integer
    # below 2^24: float32 sums equal the int64 ones.
    label, u, v, shift, rnd, clamp_rows, body = TWO_PASS_BODIES[case]
    if not body[2]:
        return
    v = np.asarray(v, np.int64)
    half = (1 << shift) >> 1
    p = 255 * np.array([v.clip(max=0).sum(), v.clip(min=0).sum()])
    q_ends = (p + half) >> shift if rnd else p
    if rnd and clamp_rows:
        q_ends = np.clip(q_ends, 0, 255)
    rng = np.random.default_rng(case)
    for q in (np.full(len(u), q_ends[1]), np.full(len(u), q_ends[0]),
              rng.integers(q_ends[0], q_ends[1] + 1, len(u)),
              np.where(np.asarray(u) < 0, q_ends[0], q_ends[1])):
        exact = np.cumsum(np.asarray(u, np.int64) * q)
        acc = np.float32(0)
        for w, x in zip(np.asarray(u, np.float32), q.astype(np.float32)):
            acc = np.float32(acc + np.float32(w * x))
        assert np.abs(exact).max() + half <= 1 << 24, label
        assert float(acc) == float(exact[-1]), label


@pytest.mark.parametrize("kh,kw,shift", [(1, 1, 0), (17, 17, 5), (9, 9, 3),
                                         (2, 2, 2), (16, 16, 4), (1, 17, 4),
                                         (17, 1, 4), (9, 3, 2), (4, 11, 3)])
def test_two_pass_u8_emulation_equals_conv_rank1_plain(kh, kw, shift):
    rng = np.random.default_rng(40 * kh + kw)
    u, v = rng.integers(0, 4, kh), rng.integers(0, 4, kw)
    planar = rng.integers(0, 256, (2, 150, 48), np.uint8)
    launch = window.two_pass_launch(u, v, shift, False, False, True)
    assert launch[2][:2] == (kh, kw) and launch[2][4:] == (shift, 0, 0, 1)
    want = window.conv_rank1_plain(torch.from_numpy(planar), u, v, shift)
    np.testing.assert_array_equal(
        emulate_two_pass_u8(planar, u, v, shift, False, False, True),
        want.numpy())


@pytest.mark.parametrize("n,lo,hi,shift", [(1, -6, 9, 3), (2, -6, 9, 3),
                                           (8, -6, 9, 3), (17, -6, 9, 3),
                                           (9, 0, 5, 5), (16, 0, 3, 5),
                                           (5, 1 << 22, 1 << 23, 3)])
def test_two_pass_u8_emulation_equals_conv_sep_plain(n, lo, hi, shift):
    rng = np.random.default_rng(50 + n)
    row = rng.integers(lo, hi, (1, n)).astype(np.int32)
    col = rng.integers(lo, hi, (n, 1)).astype(np.int32)
    planar = rng.integers(0, 256, (3, 131, 32), np.uint8)
    extra = window.convolution_separated_launch(row, col, shift)[2]
    cr, co = window.clamps(row, shift), window.clamps(col, shift)
    if n not in window.STRIP_CONV_SIZES:
        assert extra[4:] == (shift, 1, int(cr), int(co))
    want = window.conv_sep_plain(torch.from_numpy(planar), row, col, shift)
    np.testing.assert_array_equal(
        emulate_two_pass_u8(planar, col.ravel(), row.ravel(), shift, True, cr,
                            co), want.numpy())


# -- float32 ------------------------------------------------------------------

def dense_atol(mask: np.ndarray, shift: int) -> float:
    w = spec.mask_float(mask, shift)
    return mask.size * 2.0 ** -24 * float(np.abs(w).sum())


def sep_atol(row: np.ndarray, shift: int) -> float:
    w = float(np.abs(spec.mask_float(row, shift)).sum())
    return 2 * row.size * 2.0 ** -24 * w * w


@pytest.mark.parametrize("kh,kw", DENSE_SHAPES)
def test_dense_f32_matches_jax(kh, kw):
    rng = np.random.default_rng(200 * kh + kw)
    mask = rng.integers(-1000, 1001, (kh, kw)).astype(np.int32)
    shift = 10
    want, got = run_f32(lambda jl: jax_f32._make_conv(jl, mask, shift),
                        lambda lay: f32.make_conv(lay, mask, shift),
                        image(kh * kw + 1))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=dense_atol(mask, shift))
    if (kh, kw) not in ((3, 3), (5, 5)):
        assert f32.convolution_launch(mask, shift)[0] == (
            "conv_tile_dense_f32")


@pytest.mark.parametrize("n", SEP_NS)
def test_separable_f32_matches_jax(n):
    rng = np.random.default_rng(300 + n)
    row = rng.integers(-1000, 1001, (1, n)).astype(np.int32)
    want, got = run_f32(
        lambda jl: jax_f32._make_conv_sep(jl, n, row, 10),
        lambda lay: f32.make_conv_sep(lay, n, row, 10), image(90 + n))
    np.testing.assert_allclose(got, want, rtol=0, atol=sep_atol(row, 10))
    name = f32.convolution_separated_launch(row, row.T.copy(), 10)[0]
    assert name == (f"window_f32<ConvSep<{n}>>" if n in (3, 5)
                    else "conv_tile_sep_f32")


def test_bare_f32_convolution_equals_the_builder():
    mask = np.random.default_rng(5).integers(-9, 10, (3, 8)).astype(np.int32)
    layout = make_layout(H, W, pad=PAD)
    planar = to_planar_padded_f32(image(2), layout)
    assert torch.equal(f32.convolution(planar, mask, 6),
                       f32.make_conv(layout, mask, 6)(planar))


# -- refusals -----------------------------------------------------------------

def builders(pad: int):
    """(label, build) for each builder on a pad-``pad`` layout, taking the
    mask's side."""
    lay = make_layout(H, W, pad=pad)
    return [
        ("u8 dense", lambda k: window.make_convolution(
            lay, k, k, 4, np.ones((k, k), np.int32))),
        ("u8 1xk", lambda k: window.make_convolution(
            lay, 1, k, 4, np.ones((1, k), np.int32))),
        ("u8 separable", lambda k: window.make_convolution_separated_fused(
            lay, k, np.ones((1, k), np.int32), 4)),
        ("f32 dense", lambda k: f32.make_conv(
            lay, np.ones((k, 1), np.int32), 4)),
        ("f32 separable", lambda k: f32.make_conv_sep(
            lay, k, np.ones(k, np.int32), 4)),
    ]


@pytest.mark.parametrize("i", range(5))
def test_builders_refuse_a_mask_wider_than_the_pad(i):
    label, build = builders(2)[i]
    build(5)   # radius 2 fits pad 2
    for k in (6, 7, 17):
        with pytest.raises(ValueError, match="exceeds the layout halo"):
            build(k)


@pytest.mark.parametrize("i", range(5))
def test_builders_refuse_a_side_past_17(i):
    label, build = builders(8)[i]
    build(17)
    with pytest.raises(ValueError):
        build(18)


def test_bare_functions_refuse_a_side_past_17():
    planar = torch.zeros((3, 40, 48), dtype=torch.uint8)
    planar32 = torch.zeros((3, 40, 48), dtype=torch.float32)
    for shape in ((18, 1), (1, 18), (0, 3), (18, 18)):
        mask = np.ones(shape, np.int32)
        with pytest.raises(ValueError, match="sides 1 to 17"):
            window.convolution(planar, mask, 4)
        with pytest.raises(ValueError, match="sides 1 to 17"):
            f32.convolution(planar32, mask, 4)
    row = np.ones((1, 18), np.int32)
    for fn, p in ((window.convolution_separated, planar),
                  (f32.convolution_separated, planar32)):
        with pytest.raises(ValueError):
            fn(p, row, row.T.copy(), 4)
    for k in (1, 2, 9, 17):   # every side up to 17 is taken
        mask = np.ones((k, 17 - k + 1), np.int32)
        window.convolution(planar, mask, 4)
        f32.convolution(planar32, mask, 4)


def test_kernel_side_equals_the_wrappers():
    src = os.path.join(os.path.dirname(window.__file__), "kernels", "csrc",
                       "conv.cu")
    with open(src) as f:
        text = f.read()
    side = int(re.search(r"kMaxSide = (\d+);", text).group(1))
    assert side == window.MAX_CONV_SIDE == 2 * PAD + 1
    windows = int(re.search(r"kWindows = (\d+);", text).group(1))
    assert windows == window.MMA_WINDOWS


def emulate_sep_f32(planar: np.ndarray, row: np.ndarray, col: np.ndarray,
                    shift: int) -> np.ndarray:
    """conv_tile_sep_f32 in float32: the row pass from its first product
    over kx ascending, each output's column sum taken from the register
    ring in ky order."""
    wr = np.ravel(spec.mask_float(row, shift)).astype(np.float32)
    wc = np.ravel(spec.mask_float(col, shift)).astype(np.float32)
    pitch = planar.shape[2]

    def row_pass(values, x0):
        p = values[:, x0:x0 + pitch] * wr[0]
        for kx in range(1, len(wr)):
            p = p + values[:, x0 + kx:x0 + kx + pitch] * wr[kx]
        return p

    def col_step(acc, q, w):
        return q * np.float32(w) if acc is None else acc + q * np.float32(w)

    return emulate_two_pass(planar, wc, wr, row_pass, col_step, lambda d: d,
                            0.0).astype(np.float32)


@pytest.mark.parametrize("n", [1, 2, 6, 9, 16, 17])
def test_sep_f32_emulation_equals_conv_sep_plain(n):
    # Tolerance 0: the register ring keeps the JAX order of the sums.
    rng = np.random.default_rng(70 + n)
    row = rng.integers(-1000, 1001, (1, n)).astype(np.int32)
    col = rng.integers(-1000, 1001, (n, 1)).astype(np.int32)
    planar = rng.random((2, 140, 40), dtype=np.float32)
    want = f32.conv_sep_plain(torch.from_numpy(planar), row, col, 10)
    got = emulate_sep_f32(planar, row, col, 10)
    assert np.array_equal(got, want.numpy())


def test_two_pass_geometry_fits_the_ring():
    # Every tap a lane's row pass reads lies in the 16 bytes (8 floats)
    # of halo a ring row holds beside the warp's 128 columns.
    knobs = two_pass_knobs()
    assert knobs["cols"] == 128 and knobs["rows"] >= 16
    for n in range(1, window.MAX_CONV_SIDE + 1):
        assert n // 2 <= PAD and n - 1 - n // 2 <= PAD


def jax_body(mask: np.ndarray, shift: int, monkeypatch) -> str:
    """The name of the body make_convolution builds for ``mask``."""
    with monkeypatch.context() as m:
        m.setattr(jax_window, "_windowed_call",
                  lambda layout, hy, body, **kw: body.__name__)
        return jax_window.make_convolution(jax_layout(), *mask.shape, shift,
                                           mask)


# -- on the card --------------------------------------------------------------

def card_cases(rng):
    """(label, op on a planar tensor, its plain version, dtype) for each
    kernel of csrc/conv.cu."""
    cases = []
    for kh, kw in ((2, 4), (7, 5), (17, 17), (1, 17)):
        mask = random_mask(rng, kh, kw)
        cases.append((f"u8 dense {kh}x{kw}",
                      lambda p, m=mask: window.convolution(p, m, 6),
                      lambda p, m=mask: window.conv_dense_plain(p, m, 6),
                      torch.uint8))
        fmask = rng.integers(-1000, 1001, (kh, kw)).astype(np.int32)
        cases.append((f"f32 dense {kh}x{kw}",
                      lambda p, m=fmask: f32.convolution(p, m, 10),
                      lambda p, m=fmask: f32.conv_dense_plain(p, m, 10),
                      torch.float32))
    for kh, kw, big in ((7, 7, 200), (1, 17, -200), (17, 17, 300),
                        (6, 3, 128)):
        mask = wide_mask(rng, kh, kw, big)
        cases.append((f"u8 dense {kh}x{kw} with {big}",
                      lambda p, m=mask: window.convolution(p, m, 9),
                      lambda p, m=mask: window.conv_dense_plain(p, m, 9),
                      torch.uint8))
    ends = np.array([[-128, 127, 127], [127, -128, 127]] * 4 + [[5, 9, 1]])
    cases.append(("u8 dense int8 ends 9x3",
                  lambda p: window.convolution(p, ends, 8),
                  lambda p: window.conv_dense_plain(p, ends, 8), torch.uint8))
    rank1 = rank1_mask(rng, 9, 7)
    cases.append(("u8 rank 1 9x7",
                  lambda p: window.convolution(p, rank1, 5),
                  lambda p: window.convolution_plain(p, rank1, 5),
                  torch.uint8))
    for label, mask, shift in OVERFLOW:
        mask = mask.astype(np.int32)
        cases.append((f"u8 overflow {label}",
                      lambda p, m=mask, s=shift: window.convolution(p, m, s),
                      lambda p, m=mask, s=shift: window.conv_dense_plain(
                          p, m, s), torch.uint8))
    for n in (1, 8, 17):
        row = rng.integers(-6, 9, (1, n)).astype(np.int32)
        col = rng.integers(-6, 9, (n, 1)).astype(np.int32)
        cases.append((f"u8 separable {n}",
                      lambda p, r=row, c=col: window.convolution_separated(
                          p, r, c, 3),
                      lambda p, r=row, c=col: window.conv_sep_plain(
                          p, r, c, 3), torch.uint8))
        cases.append((f"f32 separable {n}",
                      lambda p, r=row, c=col: f32.convolution_separated(
                          p, r, c, 3),
                      lambda p, r=row, c=col: f32.conv_sep_plain(
                          p, r, c, 3), torch.float32))
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 25, 48), (1, 70, 4112),
                                   (3, 2357, 3520), (3, 67, 64),
                                   (2, 129, 16), (1, 33, 32), (1, 1, 16),
                                   (2, 200, 4112)])
def test_conv_tile_kernels_match_plain_on_card(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    rng = np.random.default_rng(shape[1])
    u8 = torch.from_numpy(rng.integers(0, 256, shape, np.uint8)).cuda()
    f = torch.from_numpy(rng.random(shape, dtype=np.float32)).cuda()
    names = set()
    for label, op, plain, dtype in card_cases(rng):
        planar = u8 if dtype == torch.uint8 else f
        kernels.reset_launches()
        got = op(planar)
        torch.cuda.synchronize()
        names |= set(kernels.LAUNCHES)
        assert torch.equal(got, plain(planar)), f"{label} on {shape}"
    assert {"conv_tile_dense_u8", "conv_tile_dense_mma_u8",
            "conv_tile_dense_f32"} <= names


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 129, 48), (1, 67, 16)])
def test_every_dense_side_matches_plain_on_card(shape):
    # chip_smoke.py [3l]'s sweep: every kh x kw of 1..17 on each dense
    # body (every instantiation of conv.cu's dense kernels), tolerance 0.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    import chip_smoke
    errs = chip_smoke.compare_dense_sides(np.random.default_rng(shape[1]),
                                          shape)
    assert set(errs) == {"conv_tile_dense_u8", "conv_tile_dense_mma_u8",
                         "conv_tile_dense_f32"}
    assert not any(errs.values())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 129, 48), (3, 150, 1200)])
def test_every_two_pass_side_matches_plain_on_card(shape):
    # chip_smoke.py [3l]'s sweep: every N of 1..17 on each two-pass kernel
    # (every instantiation: uint8 rounded between, unrounded N x N and
    # N x kw; float32), tolerance 0.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    import chip_smoke
    errs = chip_smoke.compare_two_pass_sides(np.random.default_rng(shape[1]),
                                             shape)
    assert set(errs) == {"conv_tile_two_pass_u8", "conv_tile_sep_f32"}
    assert not any(errs.values())
