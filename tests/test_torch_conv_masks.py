"""The port's convolution routing against the JAX package's, on any mask.

``window.convolution`` sends a mask to ``ConvRank1`` where the JAX
package's ``make_convolution`` takes ``body_rank1`` and to the general
``ConvDense`` elsewhere. These tests hold the port's copy of
``factor_rank1_int`` to the JAX one, the rank-1 plain version to the dense
one, the route to the JAX route, and the outputs to ``make_convolution``
and ``make_convolution_separated_fused`` in Pallas interpret mode (their
``body_rank1``, ``body_packed`` and ``body_i32``), on seeded random masks.
Tolerance is 0 throughout: the uint8 model is bit-exact. The card-only
test at the end holds every body of the uint8 window kernels against its
plain version at the edge shapes ``chip_smoke.py`` uses; it skips without
a CUDA device.
"""

import jax
import numpy as np
import pytest
import torch

from dip_benchmark_tpu import spec
from dip_benchmark_tpu.ops.pallas import window as jax_window
from dip_benchmark_tpu.utils import image as jax_image
from dip_benchmark_tpu_torch.ops import window
from dip_benchmark_tpu_torch.utils.image import (from_jax_planar,
                                                 from_planar_padded,
                                                 make_layout, to_planar_padded)

FACTOR_MASKS = {
    "gaussian-3x3": spec.BLUR_3X3_INT,
    "gaussian-5x5": spec.BLUR_5X5_INT,
    "zero-row-and-column": np.outer([0, 1, 2], [3, 0, 1]),
    "zero-first-row": np.outer([0, 2, 1, 3, 0], [1, 1, 2, 0, 1]),
    "first-row-needs-gcd": np.outer([2, 1, 3], [4, 8, 12]),
    "negative-weight": np.array([[1, 2, 1], [2, -4, 2], [1, 2, 1]]),
    "negative-rank-1": np.outer([1, 2, 1], [-1, 2, -1]),
    "all-zero": np.zeros((3, 3), np.int32),
    "rank-2": np.array([[1, 2, 1], [2, 4, 2], [1, 2, 2]]),
}


def random_mask(rng, n: int, kind: str) -> tuple[np.ndarray, int]:
    """(mask, shift) of one kind: "rank1" (a packable outer product),
    "packed" (nonnegative, packable, not rank 1), "negative" or "clamp" (a
    sum far above 1 << shift)."""
    if kind == "rank1":
        u, v = rng.integers(0, 4, n), rng.integers(0, 4, n)
        u[n // 2] += 1
        v[n // 2] += 1
        return np.outer(u, v).astype(np.int32), int(rng.integers(1, 9))
    if kind == "packed":
        return rng.integers(0, 9, (n, n)).astype(np.int32), 5
    if kind == "negative":
        return rng.integers(-9, 10, (n, n)).astype(np.int32), 3
    return rng.integers(0, 40, (n, n)).astype(np.int32), 2


KINDS = ("rank1", "packed", "negative", "clamp")
CASES = [(n, kind, seed) for n in (3, 5) for kind in KINDS
         for seed in (0, 1)]


def jax_run(build, image: np.ndarray) -> np.ndarray:
    """The JAX op built by ``build(layout)`` on ``image``, cropped to HWC."""
    h, w = image.shape[:2]
    layout = jax_image.make_layout(h, w)
    planar = jax.device_put(jax_image.to_planar_padded(image, layout))
    out = np.asarray(build(layout)(planar))
    crop = out[:, layout.pad_y:layout.pad_y + h, layout.pad_x:layout.pad_x + w]
    return np.ascontiguousarray(np.transpose(crop, (1, 2, 0)))


def port_planar(image: np.ndarray) -> torch.Tensor:
    h, w = image.shape[:2]
    jax_layout = jax_image.make_layout(h, w)
    return from_jax_planar(jax_image.to_planar_padded(image, jax_layout),
                           jax_layout)


@pytest.mark.parametrize("name", sorted(FACTOR_MASKS))
def test_factor_rank1_int_matches_jax(name):
    mask = np.asarray(FACTOR_MASKS[name], np.int32)
    want = jax_window.factor_rank1_int(mask)
    got = window.factor_rank1_int(mask)
    if want is None:
        assert got is None
        return
    assert got is not None
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(np.outer(*got), mask)


def test_factor_rank1_int_needs_the_gcd_of_the_first_row():
    u, v = window.factor_rank1_int(np.outer([2, 1, 3], [4, 8, 12]))
    np.testing.assert_array_equal(v, [1, 2, 3])
    np.testing.assert_array_equal(u, [8, 4, 12])


@pytest.mark.parametrize("seed", range(6))
def test_conv_rank1_plain_equals_dense(seed):
    rng = np.random.default_rng(seed)
    n = (3, 5)[seed % 2]
    mask, shift = random_mask(rng, n, "rank1")
    u, v = window.factor_rank1_int(mask)
    planar = torch.from_numpy(rng.integers(0, 256, (3, 13, 32), np.uint8))
    got = window.conv_rank1_plain(planar, u, v, shift)
    assert torch.equal(got, window.conv_dense_plain(planar, mask, shift))


@pytest.mark.parametrize("n,kind,seed", CASES)
def test_convolution_matches_jax_make_convolution(n, kind, seed,
                                                  small_image):
    rng = np.random.default_rng(100 * n + seed)
    mask, shift = random_mask(rng, n, kind)
    if kind == "clamp":
        assert (255 * int(mask.sum()) + (1 << shift - 1)) >> shift > 255
    want = jax_run(lambda lay: jax_window.make_convolution(
        lay, n, n, shift, mask), small_image)
    layout = make_layout(*small_image.shape[:2])
    out = window.convolution(port_planar(small_image), mask, shift)
    np.testing.assert_array_equal(from_planar_padded(out, layout), want)


@pytest.mark.parametrize("n", (3, 5))
@pytest.mark.parametrize("seed", (0, 1))
def test_convolution_separated_matches_jax(n, seed, small_image):
    # The JAX kernel takes one row mask for both passes (its masks are
    # symmetric); the port takes the row mask and its transpose.
    rng = np.random.default_rng(10 * n + seed)
    half = rng.integers(-3, 9, n // 2 + 1)
    row = np.concatenate([half, half[-2::-1]]).astype(np.int32)[None, :]
    shift = int(rng.integers(1, 5))
    want = jax_run(lambda lay: jax_window.make_convolution_separated_fused(
        lay, n, row, shift), small_image)
    layout = make_layout(*small_image.shape[:2])
    out = window.convolution_separated(port_planar(small_image), row,
                                       row.T.copy(), shift)
    np.testing.assert_array_equal(from_planar_padded(out, layout), want)


def jax_body(mask: np.ndarray, shift: int, monkeypatch) -> str:
    """The name of the body make_convolution builds for ``mask``."""
    with monkeypatch.context() as m:
        m.setattr(jax_window, "_windowed_call",
                  lambda layout, hy, body, **kw: body.__name__)
        return jax_window.make_convolution(jax_image.make_layout(16, 16,
                                                                 halo=8),
                                           *mask.shape, shift, mask)


ROUTE_MASKS = [(FACTOR_MASKS[k], 4) for k in sorted(FACTOR_MASKS)
               if k != "all-zero"] + [
    (np.outer([1, 14, 1], [1, 14, 1]), 16),          # packable, carries
    (np.outer([1, 20, 1], [1, 20, 1]), 8),           # factors, not packable
    (np.outer([0, 1, 0], [100, 57, 100]), 8),        # sum 257
] + [random_mask(np.random.default_rng(s), n, k)
     for s in (3, 4) for n in (3, 5) for k in KINDS] + [
    # Non-square, even and larger shapes: the tile kernels of conv.cu.
    (np.outer([1, 2, 1], [1, 3, 3, 1, 0, 2, 1]), 5),    # 3x7, rank 1
    (np.outer([2, 1], [1, 1, 2, 1]), 3),                # 2x4, rank 1
    (np.outer([1] * 17, [1] * 15), 8),                  # 17x15, rank 1
    (np.outer([3] * 9, [40] * 9), 8),                   # 9x9, not packable
    (np.array([[1, -2, 1, 4]]), 2),                     # 1x4, negative
    (np.arange(42).reshape(7, 6) % 5, 6),               # 7x6, rank 2
    (np.outer([1, 2, 1], [1, 2, 1]) << 22, 4),          # 3x3 that wraps
] + [(np.random.default_rng(s).integers(0, 4, (kh, kw)), 4)
     for s, (kh, kw) in enumerate([(1, 1), (4, 9), (17, 17), (9, 2)])]


def tile_rank1(name: str) -> bool:
    """Whether the route ``name`` is a rank-1 form: ``ConvRank1`` or the
    tile kernel's two passes (``convolution_launch`` never takes those
    rounded between)."""
    return name.startswith("window_u8<ConvRank1") or (
        name == "conv_tile_two_pass_u8")


@pytest.mark.parametrize("i", range(len(ROUTE_MASKS)))
def test_convolution_routes_like_jax(i, monkeypatch):
    mask, shift = ROUTE_MASKS[i]
    mask = np.asarray(mask, np.int32)
    name, entry, extra = window.convolution_launch(mask, shift)
    rank1 = jax_body(mask, shift, monkeypatch) == "body_rank1"
    kh, kw = mask.shape
    assert tile_rank1(name) == rank1
    strip = kh == kw and kh in window.STRIP_CONV_SIZES and not window.wraps(
        mask, shift)
    if strip:
        assert (name == f"window_u8<ConvRank1<{kh},{kw}>>") == rank1
        assert (entry == "dip_conv_rank1_u8") == rank1
        if not rank1:
            assert name == f"window_u8<ConvDense<{kh},{kw}>>"
    else:
        # The dense form runs on the int8 tensor cores where every weight
        # fits int8, else on the IMAD body.
        dense = ("conv_tile_dense_mma_u8" if window.fits_int8(mask)
                 else "conv_tile_dense_u8")
        assert name == ("conv_tile_two_pass_u8" if rank1 else dense)
        assert entry == "dip_" + name
    if name == "conv_tile_two_pass_u8":
        assert extra[5] == 0   # unrounded between the passes


def test_matrix_convolutions_route_to_rank1():
    for mask, shift in ((spec.BLUR_3X3_INT, spec.BLUR_3X3_SHIFT),
                        (spec.BLUR_5X5_INT, spec.BLUR_5X5_SHIFT)):
        n = mask.shape[0]
        assert window.convolution_launch(mask, shift)[0] == (
            f"window_u8<ConvRank1<{n},{n}>>")


@pytest.mark.parametrize("i", range(len(ROUTE_MASKS)))
def test_convolution_plain_routes_equal_dense(i):
    mask, shift = ROUTE_MASKS[i]
    mask = np.asarray(mask, np.int32)
    planar = torch.from_numpy(np.random.default_rng(i).integers(
        0, 256, (2, 11, 16), np.uint8))
    assert torch.equal(window.convolution_plain(planar, mask, shift),
                       window.conv_dense_plain(planar, mask, shift))


@pytest.mark.parametrize("shape", [(3, 3, 16), (1, 4, 16), (2, 2, 32)])
def test_plain_versions_zero_a_buffer_without_interior(shape):
    # A buffer no taller than the ring holds only ring rows.
    planar = torch.full(shape, 200, dtype=torch.uint8)
    for out in (window.convolution_plain(planar, spec.BLUR_5X5_INT, 8),
                window.conv_sep_plain(planar, spec.BLUR_1X5_INT,
                                      spec.BLUR_5X1_INT, 4)):
        assert not bool(out.any())
    if shape[1] < 3:
        assert not bool(window.blur3x3_plain(planar).any())
        assert not bool(window.erosion_sep_plain(planar).any())


EDGES = [f"{h}x{w}" for h, w in ((3, 3), (3, 12), (5, 28), (64, 124),
                                 (2341, 3501))] + [
    "raw (3, 3, 16)", "raw (1, 70, 4112)"]


@pytest.mark.cuda
@pytest.mark.parametrize("edge", EDGES)
def test_window_bodies_match_plain_on_card_at_edges(edge):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    import chip_smoke
    rng = np.random.default_rng(EDGES.index(edge))
    if edge.startswith("raw"):
        shape = tuple(int(s) for s in edge[5:-1].split(","))
        planar = torch.from_numpy(rng.integers(0, 256, shape, np.uint8))
    else:
        h, w = (int(s) for s in edge.split("x"))
        planar = to_planar_padded(rng.integers(0, 256, (h, w, 3), np.uint8),
                                  make_layout(h, w))
    planar = planar.cuda()
    for what, name, fn, plain in chip_smoke.edge_bodies(rng):
        got = fn(planar)
        torch.cuda.synchronize()
        assert torch.equal(got, plain(planar)), f"{name} ({what}) on {edge}"
