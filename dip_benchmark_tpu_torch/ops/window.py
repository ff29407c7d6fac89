"""Windowed ops on the planar padded image: erosions, convolutions, blur.

Every op is shape-preserving: output byte ``[c, y, x]`` is the op at padded
row ``y`` and column ``x`` wherever all its taps lie in the buffer, and 0
in the outer ``hy`` rows and ``hx`` columns. The mirror halo is baked into
the layout, so the taps need no boundary logic, and the crop of the output
is the oracle's answer.

Each op has a wrapper that launches a body of ``window_u8_strip``
(``kernels/csrc/window.cu``; launches are counted as ``window_u8<Body>``,
the generic element's as ``window_u8<Taps<Min|Max>>``)
for a tensor on the card, and a plain PyTorch version (``*_plain``) of the
same whole-buffer function that the wrapper takes only for a tensor on the
CPU.

``convolution`` takes any mask of 1 to 17 taps a side and routes it as
the JAX package's ``make_convolution`` routes it: a mask that
``factor_rank1_int`` splits into integer factors ``outer(u, v)`` and that
passes the packed-16 proof (``_packable``) runs a rank-1 form
(``body_rank1``: a row pass with ``v``, a column pass with ``u``, one
rounding), unless the caller names an ``acc_dtype``; every other mask a
dense form. The 3x3 and 5x5 masks whose int32 sums cannot wrap run the
strip bodies ``ConvRank1`` and ``ConvDense``; every other shape, and a
mask whose sums can wrap, the tile kernels of ``csrc/conv.cu``
(``conv_tile_two_pass_u8`` unrounded between the passes; the dense form
on the int8 tensor cores, ``conv_tile_dense_mma_u8``, where every weight
lies in [-128, 127] (``fits_int8``), else on ``conv_tile_dense_u8``).
``convolution_separated`` runs K9 (a 1xN pass
rounded to u8, then an Nx1 pass) on ``ConvSep<N>`` for N 3 and 5 and on
``conv_tile_two_pass_u8`` rounded between the passes for every other N
from 1 to 17. Every form computes the JAX function bit for bit, the int32
wrap on overflow included. ``make_convolution`` and
``make_convolution_separated_fused`` are the JAX package's builders: a
function of a planar tensor on one layout, refusing a mask wider than the
layout's pad.

Beside the op matrix, the JAX package's library surface for morphology:
``make_erosion(layout, taps)`` and ``make_dilation(layout, taps)`` build
the min or max over any structuring element (``mask_to_taps``) whose
radius fits the layout's halo. As in the JAX package they are routed by
the element's structure (``_tap_structure``): the 3x3 square and cross,
whose extent the kernels compile in, go to ``MinRect``/``MaxRect`` and
``MinPlus``/``MaxPlus``; any other element, rectangles and plus shapes of
other sizes included, to ``Taps<Min>``/``Taps<Max>`` (radius up to
``MAX_TAP_RADIUS``). Those run a program built here once per element
(``tap_runs``, ``taps_program``): each row of the element split into runs
of dx, a table of horizontal mins (maxes) for each run length the
program keeps, each built from a shorter one, then the vertical pass over
the rows' run tables, on a tile in shared memory (``csrc/taps.cuh``; the
float32 model's ``f32.make_erosion`` runs the same program). The ring is
the element's largest ``|dy|`` rows and ``|dx|`` columns.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from .. import spec
from ..runtime import tracing
from . import kernels

STRIP_CONV_SIZES = (3, 5)   # square masks (and N) window.cu compiles in
MAX_CONV_SIDE = 17          # conv.cu kMaxSide: 2 * the largest pad + 1
MAX_TAP_RADIUS = 8          # taps.cuh kTapsMaxRadius
MMA_WINDOWS = 44            # conv.cu kWindows: 4-byte windows a mask row
# Structuring element -> (kernel name, C entry point) in window.cu.
EROSION_KERNELS = (
    (spec.CROSS_MASK_3X3, "window_u8<MinPlus>", "dip_erosion_plus_u8"),
    (spec.SQUARE_MASK_3X3, "window_u8<MinRect>", "dip_erosion_rect_u8"),
)


# -- plain PyTorch versions ------------------------------------------------

def _tap(planar: torch.Tensor, hy: int, hx: int, dy: int,
         dx: int) -> torch.Tensor:
    """The input shifted by (dy, dx), over the interior the op computes."""
    _, hp, pitch = planar.shape
    return planar[:, hy + dy:hp - hy + dy, hx + dx:pitch - hx + dx]


def _framed(core: torch.Tensor, planar: torch.Tensor, hy: int,
            hx: int) -> torch.Tensor:
    """The interior ``core`` inside a ring of ``hy`` rows and ``hx``
    columns of zeros, shaped like ``planar`` and of its dtype."""
    out = torch.zeros_like(planar)
    _, hp, pitch = planar.shape
    out[:, hy:hp - hy, hx:pitch - hx] = core.to(planar.dtype)
    return out


def zero_ring(out: torch.Tensor, ry: int, rx: int | None = None
              ) -> torch.Tensor:
    """``out`` with its outer ``ry`` rows and ``rx`` columns (``rx``
    defaults to ``ry``; either may be 0) set to 0, in place."""
    rx = ry if rx is None else rx
    hp, pitch = out.shape[-2:]
    out[..., :ry, :] = 0
    out[..., hp - ry:, :] = 0
    out[..., :rx] = 0
    out[..., pitch - rx:] = 0
    return out


def _no_interior(planar: torch.Tensor, hy: int, hx: int) -> bool:
    """True for a buffer too small for one output outside the ring of
    ``hy`` rows and ``hx`` columns: the op's output is then all 0."""
    _, hp, pitch = planar.shape
    return hp <= 2 * hy or pitch <= 2 * hx


def wraps(int_mask: np.ndarray, shift: int) -> bool:
    """True where an int32 sum of ``int_mask`` over u8 data, plus the
    rounding's half, can pass 2^31: the JAX kernels' sums wrap there."""
    return 255 * int(np.abs(np.asarray(int_mask, np.int64)).sum()) + (
        (1 << shift) >> 1) >= 1 << 31


def clamps(int_mask: np.ndarray, shift: int) -> bool:
    """Whether the JAX quantizer (``_packed_quantizer``) clamps a sum of
    ``int_mask`` to [0, 255]: a negative weight, or a sum that can round
    past 255. Where it does not, no sum that fits int32 leaves the range,
    and a wrapped one is kept whole (its low byte is the output)."""
    m = np.asarray(int_mask, np.int64)
    half = (1 << shift) >> 1
    return bool((m < 0).any()) or (
        255 * int(m.clip(min=0).sum()) + half) >> shift > 255


def _wrap32(acc: torch.Tensor) -> torch.Tensor:
    """An int64 sum taken mod 2^32 as a signed int32 value."""
    return ((acc + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _round(acc: torch.Tensor, shift: int, clamp: bool = True
           ) -> torch.Tensor:
    """(acc + half) >> shift, clamped to [0, 255] where ``clamp`` is set.
    An int64 ``acc`` stands for an int32 sum that may wrap: it is wrapped
    first."""
    acc = acc + ((1 << shift) >> 1)
    if acc.dtype == torch.int64:
        acc = _wrap32(acc)
    acc = acc >> shift
    return torch.clamp(acc, 0, 255) if clamp else acc


def erosion_plain(planar: torch.Tensor, mask: np.ndarray) -> torch.Tensor:
    """Per-channel min over the taps of structuring element ``mask``."""
    return morphology_plain(planar, mask_to_taps(mask), torch.minimum)


def erosion_sep_plain(planar: torch.Tensor) -> torch.Tensor:
    """3x1 column min, then 1x3 min over the column mins."""
    if _no_interior(planar, 1, 1):
        return torch.zeros_like(planar)
    _, hp, pitch = planar.shape
    col = torch.minimum(torch.minimum(planar[:, 0:hp - 2], planar[:, 1:hp - 1]),
                        planar[:, 2:hp])
    core = torch.minimum(torch.minimum(col[..., 0:pitch - 2],
                                       col[..., 1:pitch - 1]),
                         col[..., 2:pitch])
    return _framed(core, planar, 1, 1)


def conv_dense_plain(planar: torch.Tensor, int_mask: np.ndarray,
                     shift: int) -> torch.Tensor:
    """Dense correlation anchored at ``(kh // 2, kw // 2)``: the int32 sum
    (wrapping as the JAX kernels' does), one round-half-up, then the clamp
    where the JAX quantizer clamps (``clamps``)."""
    kh, kw = int_mask.shape
    hy, hx = kh // 2, kw // 2
    if _no_interior(planar, hy, hx):
        return torch.zeros_like(planar)
    wide = planar.to(torch.int64 if wraps(int_mask, shift) else torch.int32)
    acc = 0
    for ky in range(kh):
        for kx in range(kw):
            acc = acc + int(int_mask[ky, kx]) * _tap(wide, hy, hx, ky - hy,
                                                     kx - hx)
    return _framed(_round(acc, shift, clamps(int_mask, shift)), planar, hy,
                   hx)


def conv_rank1_plain(planar: torch.Tensor, u: np.ndarray, v: np.ndarray,
                     shift: int) -> torch.Tensor:
    """The correlation with ``outer(u, v)``: an unrounded row pass with
    ``v``, a column pass with ``u``, one round-half-up, clamp. Integer sums
    are exact, so this equals ``conv_dense_plain`` on the outer product."""
    kh, kw = len(u), len(v)
    hy, hx = kh // 2, kw // 2
    if _no_interior(planar, hy, hx):
        return torch.zeros_like(planar)
    _, hp, pitch = planar.shape
    wide = planar.to(torch.int32)
    rows = 0
    for kx in range(kw):
        rows = rows + int(v[kx]) * wide[..., kx:pitch - 2 * hx + kx]
    acc = 0
    for ky in range(kh):
        acc = acc + int(u[ky]) * rows[:, ky:hp - 2 * hy + ky]
    return _framed(_round(acc, shift), planar, hy, hx)


def conv_sep_plain(planar: torch.Tensor, row_mask: np.ndarray,
                   col_mask: np.ndarray, shift: int) -> torch.Tensor:
    """1xN pass rounded (and clamped to u8 where ``clamps`` says the JAX
    quantizer clamps), then Nx1 pass, rounded again; int32 sums that wrap
    as the JAX kernels' do."""
    wr, wc = np.ravel(row_mask), np.ravel(col_mask)
    n = len(wr)
    h = n // 2
    if _no_interior(planar, h, h):
        return torch.zeros_like(planar)
    _, hp, pitch = planar.shape
    wide64 = wraps(wr, shift) or wraps(wc, shift)
    wide = planar.to(torch.int64 if wide64 else torch.int32)
    rows = 0
    for kx in range(n):
        rows = rows + int(wr[kx]) * wide[..., kx:pitch - 2 * h + kx]
    # Every padded row, interior columns.
    rows = _round(rows, shift, clamps(wr, shift))
    acc = 0
    for ky in range(n):
        acc = acc + int(wc[ky]) * rows[:, ky:hp - 2 * h + ky]
        if wide64:   # a whole pass-1 value times a weight fits int64
            acc = _wrap32(acc)
    return _framed(_round(acc, shift, clamps(wc, shift)), planar, h, h)


def blur3x3_plain(planar: torch.Tensor) -> torch.Tensor:
    """Op #14: 1-2-1 x 1-2-1 with constant weights, (o + 8) >> 4."""
    if _no_interior(planar, 1, 1):
        return torch.zeros_like(planar)
    _, hp, pitch = planar.shape
    wide = planar.to(torch.int32)
    col = wide[:, 0:hp - 2] + 2 * wide[:, 1:hp - 1] + wide[:, 2:hp]
    o = (col[..., 0:pitch - 2] + 2 * col[..., 1:pitch - 1]
         + col[..., 2:pitch])
    return _framed((o + 8) >> 4, planar, 1, 1)


# -- wrappers --------------------------------------------------------------

def _launch_window(name: str, entry: str, planar: torch.Tensor,
                   *extra) -> torch.Tensor:
    out = tracing.call("alloc", torch.empty_like, planar)
    c, hp, pitch = planar.shape
    kernels.launch(name, entry, planar.device, planar.data_ptr(),
                   out.data_ptr(), c, hp, pitch, *extra)
    return out


def _int_array(values) -> ctypes.Array:
    flat = [int(v) for v in np.ravel(values)]
    return (ctypes.c_int * len(flat))(*flat)


def erosion(planar: torch.Tensor, mask: np.ndarray) -> torch.Tensor:
    """Erosion by the 3x3 cross or square structuring element."""
    kernels.check_planar(planar)
    found = [k for k in EROSION_KERNELS if np.array_equal(k[0], mask)]
    if not found:
        raise ValueError(f"no erosion kernel for the mask\n{mask}")
    if kernels.on_cpu(planar):
        return erosion_plain(planar, mask)
    _, name, entry = found[0]
    return _launch_window(name, entry, planar)


def erosion_separated(planar: torch.Tensor) -> torch.Tensor:
    kernels.check_planar(planar)
    if kernels.on_cpu(planar):
        return erosion_sep_plain(planar)
    return _launch_window("window_u8<MinSep>", "dip_erosion_sep_u8", planar)


def _packable(int_mask: np.ndarray) -> bool:
    """The packed-16 proof of the JAX package (``window.py:_packable``):
    nonnegative weights whose sums over u8 data stay below 2^16."""
    return bool((int_mask >= 0).all()) and 255 * int(int_mask.sum()) < (
        1 << 16)


def factor_rank1_int(int_mask: np.ndarray):
    """(u, v) integer factors with mask == outer(u, v) exactly, or None.

    The port's copy of the JAX package's ``factor_rank1_int``: a rank-1
    integer mask runs as an unrounded row pass followed by a column pass
    with one final rounding, bit-identical to the dense form at kh + kw
    multiply-adds instead of kh * kw. Both Gaussian masks factor.
    """
    m = int_mask.astype(np.int64)
    if (m < 0).any() or m.sum() == 0:
        return None
    r = next((row for row in m if row.any()), None)
    if r is None:
        return None
    g = np.gcd.reduce(r[r != 0]) if (r != 0).any() else 1
    v = r // g
    u = []
    for row in m:
        nz = v != 0
        if not nz.any():
            return None
        q, rem = np.divmod(row[nz], v[nz])
        if rem.any() or not (q == q[0]).all() or not (row[~nz] == 0).all():
            return None
        u.append(int(q[0]))
    u = np.array(u, dtype=np.int64)
    if not (np.outer(u, v) == m).all():
        return None
    return u.astype(np.int32), v.astype(np.int32)


def fits_int8(int_mask: np.ndarray) -> bool:
    """Whether every weight lies in [-128, 127]: the int8 tensor-core body
    then computes the dense form exactly (a sum is at most 289 * 255 * 128
    in magnitude, so it cannot wrap)."""
    m = np.asarray(int_mask, np.int64)
    return bool(((m >= -128) & (m <= 127)).all())


def mma_windows(int_mask: np.ndarray) -> np.ndarray:
    """The band of each mask row as ``conv_tile_dense_mma_u8`` takes it:
    ``(kh, MMA_WINDOWS)`` uint32, word ``e`` of row ``ky`` the bytes
    ``w[ky, e - 23 + kw // 2 + b]`` for b = 0..3 (0 off the row), lowest
    first. The kernel's A operand for mask row ky is the 16 x 32 int8
    matrix ``A[m, k] = w[ky, k - m - 8 + kw // 2]``; its register j in
    lane (g, t) is word ``4 t + 16 (j // 2) - g - 8 (j % 2) + 15``."""
    m = np.asarray(int_mask, np.int64)
    kh, kw = m.shape
    padded = np.zeros((kh, MMA_WINDOWS + 3), np.int64)
    lead = 23 - kw // 2   # padded column of w[ky, 0]
    padded[:, lead:lead + kw] = m
    idx = np.arange(MMA_WINDOWS)[:, None] + np.arange(4)[None, :]
    window = padded[:, idx] & 0xFF                    # (kh, windows, 4)
    return (window << (8 * np.arange(4))).sum(-1).astype(np.uint32)


def _mask_key(int_mask: np.ndarray) -> tuple:
    m = np.asarray(int_mask, np.int64)
    return m.shape, m.tobytes()


def _mask_of(shape: tuple, data: bytes) -> np.ndarray:
    return np.frombuffer(data, np.int64).reshape(shape)


@functools.lru_cache(maxsize=256)
def _rank1_factors(shape: tuple, data: bytes):
    int_mask = _mask_of(shape, data)
    return factor_rank1_int(int_mask) if _packable(int_mask) else None


def rank1_factors(int_mask: np.ndarray):
    """The (u, v) that ``convolution`` runs ``ConvRank1`` with, or None for
    the general ``ConvDense``: where ``make_convolution`` takes
    ``body_rank1`` (a packable mask that factors). Cached by mask: the
    factoring costs more host time than the kernel does device time."""
    return _rank1_factors(*_mask_key(int_mask))


def check_conv_shape(kh: int, kw: int) -> None:
    """Raise ValueError for a mask side outside 1..MAX_CONV_SIDE."""
    if not (1 <= kh <= MAX_CONV_SIDE and 1 <= kw <= MAX_CONV_SIDE):
        raise ValueError(f"no convolution kernel for a {kh}x{kw} mask "
                         f"(sides 1 to {MAX_CONV_SIDE})")


def convolution_launch(int_mask: np.ndarray, shift: int,
                       acc_dtype=None) -> tuple:
    """(kernel name, C entry point, its arguments after the geometry) of
    ``convolution`` for this mask, built once per mask and shift. Any
    ``acc_dtype`` takes the dense form, as in ``make_convolution``."""
    check_conv_shape(*int_mask.shape)
    return _convolution_launch(*_mask_key(int_mask), int(shift),
                               acc_dtype is not None)


@functools.lru_cache(maxsize=256)
def _convolution_launch(shape: tuple, data: bytes, shift: int,
                        dense: bool) -> tuple:
    int_mask = _mask_of(shape, data)
    kh, kw = shape
    uv = None if dense else _rank1_factors(shape, data)
    if kh == kw and kh in STRIP_CONV_SIZES and not wraps(int_mask, shift):
        if uv is not None:
            return (f"window_u8<ConvRank1<{kh},{kw}>>", "dip_conv_rank1_u8",
                    (kh, kw, _int_array(uv[0]), _int_array(uv[1]), shift))
        return (f"window_u8<ConvDense<{kh},{kw}>>", "dip_conv_dense_u8",
                (kh, kw, _int_array(int_mask), shift))
    if uv is not None:   # packable: no sum wraps, and the clamp is exact
        return two_pass_launch(uv[0], uv[1], shift, False, False, True)
    clamp = int(clamps(int_mask, shift))
    if fits_int8(int_mask):
        win = mma_windows(int_mask).ravel()
        return ("conv_tile_dense_mma_u8", "dip_conv_tile_dense_mma_u8",
                (kh, kw, (ctypes.c_uint * win.size)(*win.tolist()), shift,
                 clamp))
    return ("conv_tile_dense_u8", "dip_conv_tile_dense_u8",
            (kh, kw, _int_array(int_mask), shift, clamp))


def two_pass_launch(u, v, shift: int, round_between: bool, clamp_rows: bool,
                    clamp_out: bool) -> tuple:
    """(kernel name, C entry point, its arguments after the geometry) of
    ``conv_tile_two_pass_u8`` for the correlation with ``outer(u, v)``: a
    row pass with ``v``, rounded between the passes (clamped by
    ``clamp_rows``) where ``round_between`` is set, then a column pass
    with ``u``, rounded and clamped by ``clamp_out``."""
    u, v = np.ravel(u), np.ravel(v)
    return ("conv_tile_two_pass_u8", "dip_conv_tile_two_pass_u8",
            (len(u), len(v), _int_array(u), _int_array(v), int(shift),
             int(round_between), int(clamp_rows), int(clamp_out)))


def two_pass_body(u, v, shift: int, round_between: bool,
                  clamp_rows: bool) -> tuple:
    """(square, digits, float columns) of the ``conv_tile_two_pass_u8``
    instantiation its C entry point picks for these passes: the row pass
    compiled for kw where kw == kh (else for 17 taps), 1 or 2 base-256
    digits of the row weights with the column pass in float (where every
    column sum is an integer below 2^24, exact), else 4 digits with it in
    uint32."""
    u, v = np.ravel(u).astype(np.int64), np.ravel(v).astype(np.int64)
    digits = 1
    for w in v.tolist():
        w &= 0xFFFFFFFF
        n = 0
        while w and n < 4:
            d = (w & 255) - (256 if w & 128 else 0)
            w = ((w - d) & 0xFFFFFFFF) >> 8
            n += 1
        digits = max(digits, n)
    half = (1 << shift) >> 1
    rh = half if round_between else 0
    p_lo, p_hi = 255 * int(v.clip(max=0).sum()), 255 * int(v.clip(min=0).sum())
    q_lo, q_hi = (((p_lo + rh) >> shift, (p_hi + rh) >> shift)
                  if round_between else (p_lo, p_hi))
    q_max = 255 if round_between and clamp_rows else max(q_hi, -q_lo)
    float_cols = (p_hi + rh < 1 << 31 and p_lo >= -(1 << 31)
                  and q_max < 1 << 22
                  and q_max * int(np.abs(u).sum()) + half <= 1 << 24)
    if float_cols and digits <= 2:
        return len(u) == len(v), digits, True
    return len(u) == len(v), 4, False


def convolution_plain(planar: torch.Tensor, int_mask: np.ndarray,
                      shift: int, acc_dtype=None) -> torch.Tensor:
    """The plain version of the form ``convolution`` routes the mask to."""
    uv = None if acc_dtype is not None else rank1_factors(int_mask)
    if uv is not None:
        return conv_rank1_plain(planar, *uv, shift)
    return conv_dense_plain(planar, int_mask, shift)


def convolution(planar: torch.Tensor, int_mask: np.ndarray, shift: int,
                acc_dtype=None) -> torch.Tensor:
    """Dense correlation with a runtime integer mask of 1 to 17 taps a
    side, anchored at ``(kh // 2, kw // 2)``."""
    kernels.check_planar(planar)
    check_conv_shape(*int_mask.shape)
    if kernels.on_cpu(planar):
        return convolution_plain(planar, int_mask, shift, acc_dtype)
    name, entry, extra = convolution_launch(int_mask, shift, acc_dtype)
    return _launch_window(name, entry, planar, *extra)


def separable_taps(row_mask: np.ndarray, col_mask: np.ndarray) -> int:
    """N of a 1xN row mask and its Nx1 column mask; ValueError for any
    other pair or an N outside 1..MAX_CONV_SIDE."""
    n = row_mask.size
    if row_mask.shape != (1, n) or col_mask.shape != (n, 1):
        raise ValueError(f"no separable convolution kernel for masks "
                         f"{row_mask.shape} and {col_mask.shape}")
    check_conv_shape(n, n)
    return n


def convolution_separated_launch(row_mask: np.ndarray, col_mask: np.ndarray,
                                 shift: int) -> tuple:
    """(kernel name, C entry point, its arguments after the geometry) of
    ``convolution_separated``, built once per pair of masks and shift."""
    separable_taps(row_mask, col_mask)
    return _separated_launch(_mask_key(row_mask), _mask_key(col_mask),
                             int(shift))


@functools.lru_cache(maxsize=256)
def _separated_launch(row: tuple, col: tuple, shift: int) -> tuple:
    row_mask, col_mask = _mask_of(*row), _mask_of(*col)
    n = row_mask.size
    if n in STRIP_CONV_SIZES and not (wraps(row_mask, shift)
                                      or wraps(col_mask, shift)):
        return (f"window_u8<ConvSep<{n}>>", "dip_conv_sep_u8",
                (n, _int_array(row_mask), _int_array(col_mask), shift))
    return two_pass_launch(col_mask, row_mask, shift, True,
                           clamps(row_mask, shift), clamps(col_mask, shift))


def convolution_separated(planar: torch.Tensor, row_mask: np.ndarray,
                          col_mask: np.ndarray, shift: int) -> torch.Tensor:
    """1xN then Nx1 correlation, each pass rounded to u8, N from 1 to 17."""
    kernels.check_planar(planar)
    separable_taps(row_mask, col_mask)
    if kernels.on_cpu(planar):
        return conv_sep_plain(planar, row_mask, col_mask, shift)
    name, entry, extra = convolution_separated_launch(row_mask, col_mask,
                                                      shift)
    return _launch_window(name, entry, planar, *extra)


def check_radius(layout, hy: int, hx: int, what: str) -> None:
    """Raise ValueError where a window of ``hy`` rows and ``hx`` columns
    on each side reaches past the layout's mirror halo."""
    if hy > layout.pad or hx > layout.pad:
        raise ValueError(
            f"{what} radius (ry={hy}, rx={hx}) exceeds the layout halo "
            f"(pad={layout.pad}); build the layout with pad={max(hy, hx)}")


def layout_op(layout, dtype: torch.dtype, name: str, plain, launch):
    """The op of one layout: a function of its ``(C, Hp, pitch)`` tensor of
    ``dtype`` that runs ``plain`` on the CPU and ``launch`` on the card;
    ``op.kernel`` names the kernel."""
    def op(planar: torch.Tensor) -> torch.Tensor:
        kernels.check_planar(planar, dtype=dtype)
        if tuple(planar.shape) != layout.shape:
            raise ValueError(f"built for {layout.shape}, got "
                             f"{tuple(planar.shape)}")
        if kernels.on_cpu(planar):
            return plain(planar)
        return launch(planar)

    op.kernel = name
    return op


def make_convolution(layout, kh: int, kw: int, shift: int,
                     int_mask: np.ndarray, acc_dtype=None):
    """Dense kh x kw correlation on ``layout`` (the JAX package's
    ``make_convolution``): 1 to 17 taps a side, the mask's half-sizes
    within the layout's pad; any ``acc_dtype`` takes the dense form."""
    int_mask = np.asarray(int_mask)
    if int_mask.shape != (kh, kw):
        raise ValueError(f"mask of shape {int_mask.shape}, want {(kh, kw)}")
    check_conv_shape(kh, kw)
    check_radius(layout, kh // 2, kw // 2, f"{kh}x{kw} mask")
    name, entry, extra = convolution_launch(int_mask, shift, acc_dtype)
    return layout_op(
        layout, torch.uint8, name,
        lambda p: convolution_plain(p, int_mask, shift, acc_dtype),
        lambda p: _launch_window(name, entry, p, *extra))


def separable_pair(layout, n: int, row_mask: np.ndarray) -> tuple:
    """(1xN row mask, its Nx1 transpose) from the n weights of
    ``row_mask``, the one mask the JAX builders take for both passes;
    ValueError for another count, or an N past 17 or wider than the
    layout's pad."""
    row = np.asarray(row_mask).reshape(1, -1)
    if row.shape[1] != n:
        raise ValueError(f"row mask of {row.shape[1]} weights, want {n}")
    col = np.ascontiguousarray(row.T)
    separable_taps(row, col)
    check_radius(layout, n // 2, n // 2, f"1x{n} mask")
    return row, col


def make_convolution_separated_fused(layout, n: int, row_mask: np.ndarray,
                                     shift: int):
    """The 1xN pass, rounded to u8, then the Nx1 pass, with the one mask
    ``row_mask`` (n weights) for both, as the JAX package's
    ``make_convolution_separated_fused`` takes it; N from 1 to 17, N // 2
    within the layout's pad."""
    row, col = separable_pair(layout, n, row_mask)
    name, entry, extra = convolution_separated_launch(row, col, shift)
    return layout_op(layout, torch.uint8, name,
                     lambda p: conv_sep_plain(p, row, col, shift),
                     lambda p: _launch_window(name, entry, p, *extra))


def gaussian_blur_3x3(planar: torch.Tensor) -> torch.Tensor:
    kernels.check_planar(planar)
    if kernels.on_cpu(planar):
        return blur3x3_plain(planar)
    return _launch_window("window_u8<Blur3x3>", "dip_blur3x3_u8", planar)


# -- the morphology library surface ----------------------------------------

def mask_to_taps(mask: np.ndarray) -> tuple[tuple[int, int], ...]:
    """The (dy, dx) offsets of a structuring element's set cells."""
    mh, mw = mask.shape
    return tuple((my - mh // 2, mx - mw // 2)
                 for my in range(mh) for mx in range(mw) if mask[my, mx])


def _tap_structure(taps: tuple[tuple[int, int], ...]) -> str:
    s = set(taps)
    dys = sorted({dy for dy, _ in taps})
    dxs = sorted({dx for _, dx in taps})
    if s == {(dy, dx) for dy in dys for dx in dxs}:
        return "rect"
    if (0, 0) in s and s == {(dy, 0) for dy in dys} | {(0, dx) for dx in dxs}:
        return "plus"
    return "generic"


def morphology_plain(planar: torch.Tensor, taps, reduce) -> torch.Tensor:
    """``reduce`` (``torch.minimum`` or ``torch.maximum``) over the taps,
    0 in the ring of the largest ``|dy|`` rows and ``|dx|`` columns."""
    hy = max(abs(dy) for dy, _ in taps)
    hx = max(abs(dx) for _, dx in taps)
    if _no_interior(planar, hy, hx):
        return torch.zeros_like(planar)
    core = None
    for dy, dx in sorted(taps):
        t = _tap(planar, hy, hx, dy, dx)
        core = t if core is None else reduce(core, t)
    return _framed(core, planar, hy, hx)


# -- the generic structuring element: runs, then rows ----------------------
#
# Taps<Min|Max> (csrc/taps.cuh) run a small program over a tile held in
# shared memory. A table H_L holds, for each position p of each row of the
# tile, the min (max) of the L inputs p .. p + L - 1 of that row; H_1 is the
# input. Each instruction makes one table as the min (max) of shifted
# tables made before it, and the last one makes the output as the min (max)
# over the element's rows of the tables its runs need, each shifted by
# (dy, lo). The program is built here, once per element, and travels by
# value in the kernel's arguments.

# taps.cuh kTapsRowsU8, kTapsRowsF32: output rows of a tile.
TAPS_TILE_ROWS = {"uint8": 64, "float32": 32}
TAPS_FRAME = 128         # taps.cuh kTapsFrame: positions of a tile row
TAPS_MAX_SLOTS = 8       # taps.cuh kTapsMaxSlots: tables held at once
TAPS_MAX_INSTRS = 40     # taps.cuh kTapsMaxInstrs
TAPS_MAX_TERMS = 400     # taps.cuh kTapsMaxTerms
DIRECT_RUN = 3           # a run this short is built from the input taps


@dataclasses.dataclass(frozen=True)
class TapRuns:
    """A structuring element as horizontal runs.

    ``runs[dy + hy]`` lists the maximal runs ``(lo, hi)`` of dx in row dy
    (empty for a row with no tap). ``builds`` lists, in build order, each
    run length ``L`` > 1 that a row or a later build needs, as ``(L,
    terms)``: ``H_L[p]`` is the min (max) over ``(a, shift)`` in ``terms``
    of ``H_a[p + shift]``, where every ``a`` is 1 or a length built before
    ``L``. ``rows[dy + hy]`` lists the terms ``(L, dx)`` whose tables the
    output reduces in row dy: ``H_L`` shifted by dx covers the taps
    ``dx .. dx + L - 1`` of the row.
    """
    hy: int
    hx: int
    runs: tuple
    builds: tuple
    rows: tuple

    def taps(self) -> set:
        """The (dy, dx) the rows cover: the element's taps."""
        return {(dy - self.hy, dx + k) for dy, terms in enumerate(self.rows)
                for length, dx in terms for k in range(length)}


def _row_runs(dxs) -> tuple:
    runs, lo = [], None
    for dx in sorted(dxs):
        if lo is None or dx != hi + 1:
            if lo is not None:
                runs.append((lo, hi))
            lo = dx
        hi = dx
    if lo is not None:
        runs.append((lo, hi))
    return tuple(runs)


def tap_runs(taps, tables=None) -> TapRuns:
    """The element ``taps`` as runs, with a table for each length in
    ``tables`` (default: each run length of the element; ``"pow2"``: the
    powers of two up to the longest run, at most five tables for any
    element). A table is built from the largest shorter table that covers
    half of it, or from the input taps up to ``DIRECT_RUN``, or else from a
    table of half its length, built first. A run whose length has no table
    is the union of two shifted copies of the longest table no longer than
    the run that covers half of it, or has a table built for it."""
    taps = tuple((int(dy), int(dx)) for dy, dx in taps)
    hy = max(abs(dy) for dy, _ in taps)
    hx = max(abs(dx) for _, dx in taps)
    runs = tuple(_row_runs({dx for d, dx in taps if d == dy})
                 for dy in range(-hy, hy + 1))
    lengths = sorted({hi - lo + 1 for row in runs for lo, hi in row})
    if tables is None:
        tables = lengths
    elif tables == "pow2":
        tables = [1 << k for k in range(1, lengths[-1].bit_length())]
    built, builds = {1}, []

    def cover(length: int):
        return max((a for a in built if a < length <= 2 * a), default=None)

    def need(length: int) -> None:
        if length in built:
            return
        a = cover(length)
        if a is not None:
            terms = ((a, 0), (a, length - a))
        elif length <= DIRECT_RUN:
            terms = tuple((1, k) for k in range(length))
        else:
            a = (length + 1) // 2
            need(a)
            terms = ((a, 0), (a, length - a))
        builds.append((length, terms))
        built.add(length)

    for length in sorted(tables):
        need(length)
    rows = []
    for row in runs:
        terms = []
        for lo, hi in row:
            length = hi - lo + 1
            if length not in built and cover(length) is None:
                need(length)
            a = length if length in built else cover(length)
            terms += [(a, lo)] if a == length else [(a, lo),
                                                    (a, hi - a + 1)]
        rows.append(tuple(terms))
    used = {a for row in rows for a, _ in row}
    for length, terms in reversed(builds):   # drop tables nothing reads
        if length not in used:
            builds.remove((length, terms))
        else:
            used |= {a for a, _ in terms}
    return TapRuns(hy, hx, runs, tuple(builds), tuple(rows))


@dataclasses.dataclass(frozen=True)
class TapsProgram:
    """The instructions of the Taps kernels for one element.

    Tables live in ``slots`` shared-memory slots of ``rows + 2 hy`` frame
    rows each (``rows``: the tile's output rows); frame row f is image row ``y0 - hy + f`` of a
    tile whose outputs are rows ``y0 ..``, and frame position q is column
    ``x0 - margin + q``. Slot 0 holds the input. Each instruction is
    ``(dst, r0, r1, terms)``: for frame rows ``[r0, r1)`` and every
    position, the min (max) over ``(slot, dy, dx)`` in ``terms`` of that
    slot at row + dy and position + dx; the last one is the output (rows
    ``[hy, hy + rows)``), which the kernel stores, so its dst is -1.
    """
    hy: int
    hx: int
    margin: int
    slots: int
    instrs: tuple
    rows: int
    tables: tuple

    def encode(self) -> list[int]:
        """The int32 words ``dip_*_taps_*`` parse: hy, hx, margin, slots,
        the instruction count, then each instruction as dst, r0, r1, its
        term count and each term as slot, dy, dx."""
        words = [self.hy, self.hx, self.margin, self.slots, len(self.instrs)]
        for dst, r0, r1, terms in self.instrs:
            words += [dst, r0, r1, len(terms)]
            for term in terms:
                words += list(term)
        return words

    def stats(self) -> dict:
        """Per output position of a tile: shared-memory reads (a read at an
        odd dx takes two words in the uint8 kernel: ``odd_reads``), writes
        and min/max operations, frame columns not counted."""
        rows = self.rows
        reads = sum((r1 - r0) * len(t) for _, r0, r1, t in self.instrs)
        odd = sum((r1 - r0) * sum(dx & 1 for *_, dx in t)
                  for _, r0, r1, t in self.instrs)
        writes = sum(r1 - r0 for _, r0, r1, _ in self.instrs[:-1]) + rows
        ops = sum((r1 - r0) * (len(t) - 1) for _, r0, r1, t in self.instrs)
        return {"instrs": len(self.instrs), "slots": self.slots,
                "tables": self.tables, "reads": reads / rows,
                "odd_reads": odd / rows, "writes": writes / rows,
                "ops": ops / rows}

    def cost(self) -> float:
        """What ``taps_program`` minimises: shared-memory reads, an odd-dx
        read at one and a half, and writes, an output. On the H100 it
        ranks the programs of the library's elements as their times do
        (``window_lab.py --programs``, PERF.md)."""
        s = self.stats()
        return s["reads"] + 0.5 * s["odd_reads"] + s["writes"]


def _compile(runs: TapRuns, rows_out: int) -> TapsProgram:
    hy = runs.hy
    out_terms = [(length, dy - hy, dx) for dy, row in enumerate(runs.rows)
                 for length, dx in row]
    # Frame rows each table is needed on, from the output back.
    need = {}

    def extend(length, r0, r1):
        a, b = need.get(length, (r0, r1))
        need[length] = (min(a, r0), max(b, r1))

    for length, dy, _ in out_terms:
        extend(length, hy + dy, hy + rows_out + dy)
    for length, terms in reversed(runs.builds):
        for a, _ in terms:
            extend(a, *need[length])
    # Slots: a table's slot is free after the last instruction that reads
    # it; an instruction never writes a slot it reads.
    n = len(runs.builds)
    last = {1: -1}
    for i, (_, terms) in enumerate(runs.builds):
        for a, _ in terms:
            last[a] = i
    for length, _, _ in out_terms:
        last[length] = n
    slot_of, free, used = {1: 0}, [], 1
    instrs = []
    for i, (length, terms) in enumerate(runs.builds):
        if free:
            dst = free.pop(0)
        else:
            dst, used = used, used + 1
        r0, r1 = need[length]
        instrs.append((dst, r0, r1, tuple((slot_of[a], 0, s)
                                          for a, s in terms)))
        for a, _ in terms:
            if last[a] == i and a in slot_of:
                free.append(slot_of.pop(a))
                free.sort()
        slot_of[length] = dst
    instrs.append((-1, hy, hy + rows_out,
                   tuple((slot_of[length], dy, dx)
                         for length, dy, dx in out_terms)))
    margin = 4 if runs.hx <= 4 else 8
    return TapsProgram(hy, runs.hx, margin, used, tuple(instrs), rows_out,
                       tuple(length for length, _ in runs.builds))


def _fits(prog: TapsProgram) -> bool:
    return (prog.slots <= TAPS_MAX_SLOTS
            and len(prog.instrs) <= TAPS_MAX_INSTRS
            and sum(len(t) for *_, t in prog.instrs) <= TAPS_MAX_TERMS)


@functools.lru_cache(maxsize=256)
def taps_program(taps, rows: int) -> TapsProgram:
    """The Taps kernels' program for element ``taps``: the cheapest
    (``TapsProgram.cost``) that fits the kernels' limits of the
    power-of-two tables and of the tables of the element's run lengths
    less any whose dropping lowers the cost (greedily, one at a time).
    ``rows``: the tile's output rows (``TAPS_TILE_ROWS`` of the data
    model; other values only for kernels built with others, as the lab
    builds them)."""
    taps = tuple(sorted({(int(dy), int(dx)) for dy, dx in taps}))

    def program(tables):
        prog = _compile(tap_runs(taps, tables), rows)
        return prog if _fits(prog) else None

    progs = [p for p in (program("pow2"),) if p]
    tables = {length for length, _ in tap_runs(taps).builds}
    best = program(sorted(tables))
    while best is not None:
        progs.append(best)
        trials = [p for p in (program(sorted(tables - {length}))
                              for length in sorted(tables)) if p]
        better = [p for p in trials if p.cost() < best.cost()]
        if not better:
            break
        best = min(better, key=TapsProgram.cost)
        tables = set(best.tables)
    return min(progs, key=TapsProgram.cost)


# (dtype, reduce, body) -> (kernel name, C entry point).
MORPHOLOGY_KERNELS = {
    ("uint8", "min", "rect"): ("window_u8<MinRect>", "dip_erosion_rect_u8"),
    ("uint8", "min", "plus"): ("window_u8<MinPlus>", "dip_erosion_plus_u8"),
    ("uint8", "min", "taps"): ("window_u8<Taps<Min>>",
                               "dip_erosion_taps_u8"),
    ("uint8", "max", "rect"): ("window_u8<MaxRect>", "dip_dilation_rect_u8"),
    ("uint8", "max", "plus"): ("window_u8<MaxPlus>", "dip_dilation_plus_u8"),
    ("uint8", "max", "taps"): ("window_u8<Taps<Max>>",
                               "dip_dilation_taps_u8"),
    ("float32", "min", "rect"): ("window_f32<MinRect>",
                                 "dip_erosion_rect_f32"),
    ("float32", "min", "plus"): ("window_f32<MinPlus>",
                                 "dip_erosion_plus_f32"),
    ("float32", "min", "taps"): ("window_f32<Taps<Min>>",
                                 "dip_erosion_taps_f32"),
}


def morphology_launch(taps, reduce: str, dtype: str = "uint8") -> tuple:
    """(kernel name, C entry point, its arguments after the geometry) of
    the min or max over ``taps``, routed by the element's structure."""
    hy = max(abs(dy) for dy, _ in taps)
    hx = max(abs(dx) for _, dx in taps)
    body = _tap_structure(taps)
    extent = ({dy for dy, _ in taps} == {-1, 0, 1}
              and {dx for _, dx in taps} == {-1, 0, 1})
    if body == "generic" or not extent:
        body = "taps"
    if body == "taps" and max(hy, hx) > MAX_TAP_RADIUS:
        raise ValueError(f"structuring element radius {max(hy, hx)} "
                         f"exceeds the kernels' {MAX_TAP_RADIUS}")
    name, entry = MORPHOLOGY_KERNELS[(dtype, reduce, body)]
    extra = ()
    if body == "taps":
        words = taps_program(tuple(taps), TAPS_TILE_ROWS[dtype]).encode()
        extra = (_int_array(words), len(words))
    return name, entry, extra


def make_morphology(layout, taps, reduce: str, dtype: str = "uint8"):
    """The min (``reduce="min"``) or max over structuring element ``taps``
    on ``layout``: a function of the ``(C, Hp, pitch)`` tensor of
    ``dtype`` that returns a tensor of the same layout."""
    taps = tuple((int(dy), int(dx)) for dy, dx in taps)
    if not taps:
        raise ValueError("empty structuring element")
    check_radius(layout, max(abs(dy) for dy, _ in taps),
                 max(abs(dx) for _, dx in taps), "structuring element")
    name, entry, extra = morphology_launch(taps, reduce, dtype)
    plain_reduce = torch.minimum if reduce == "min" else torch.maximum
    return layout_op(
        layout, torch.float32 if dtype == "float32" else torch.uint8, name,
        lambda p: morphology_plain(p, taps, plain_reduce),
        lambda p: _launch_window(name, entry, p, *extra))


def make_erosion(layout, taps):
    """Per-channel min over ``taps`` (the JAX package's ``make_erosion``)."""
    return make_morphology(layout, taps, "min")


def make_dilation(layout, taps):
    """Per-channel max over ``taps`` (the JAX package's ``make_dilation``),
    with the layout's mirror borders like every op here."""
    return make_morphology(layout, taps, "max")
