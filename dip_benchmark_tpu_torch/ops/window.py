"""Windowed ops on the planar padded image: erosions, convolutions, blur.

Every op is shape-preserving: output byte ``[c, y, x]`` is the op at padded
row ``y`` and column ``x`` wherever all its taps lie in the buffer, and 0
in the outer ``hy`` rows and ``hx`` columns. The mirror halo is baked into
the layout, so the taps need no boundary logic, and the crop of the output
is the oracle's answer.

Each op has a wrapper that launches ``window_u8<Body>`` (``kernels/csrc/
window.cu``) for a tensor on the card, and a plain PyTorch version
(``*_plain``) of the same whole-buffer function that the wrapper takes
only for a tensor on the CPU.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import spec

from . import kernels

CONV_DENSE_SIZES = (3, 5)   # square mask sizes window.cu builds
CONV_SEP_SIZES = (3, 5)
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


def zero_ring(out: torch.Tensor, r: int) -> torch.Tensor:
    """``out`` with its outer ``r`` rows and columns set to 0, in place."""
    out[..., :r, :] = 0
    out[..., -r:, :] = 0
    out[..., :r] = 0
    out[..., -r:] = 0
    return out


def _round(acc: torch.Tensor, shift: int) -> torch.Tensor:
    half = (1 << shift) >> 1
    return torch.clamp((acc + half) >> shift, 0, 255)


def erosion_plain(planar: torch.Tensor, mask: np.ndarray) -> torch.Tensor:
    """Per-channel min over the taps of structuring element ``mask``."""
    mh, mw = mask.shape
    hy, hx = mh // 2, mw // 2
    core = None
    for my, mx in zip(*np.nonzero(mask)):
        t = _tap(planar, hy, hx, int(my) - hy, int(mx) - hx)
        core = t if core is None else torch.minimum(core, t)
    return _framed(core, planar, hy, hx)


def erosion_sep_plain(planar: torch.Tensor) -> torch.Tensor:
    """3x1 column min, then 1x3 min over the column mins."""
    _, hp, pitch = planar.shape
    col = torch.minimum(torch.minimum(planar[:, 0:hp - 2], planar[:, 1:hp - 1]),
                        planar[:, 2:hp])
    core = torch.minimum(torch.minimum(col[..., 0:pitch - 2],
                                       col[..., 1:pitch - 1]),
                         col[..., 2:pitch])
    return _framed(core, planar, 1, 1)


def conv_dense_plain(planar: torch.Tensor, int_mask: np.ndarray,
                     shift: int) -> torch.Tensor:
    """Dense correlation, int32 sum, one round-half-up, clamp."""
    kh, kw = int_mask.shape
    hy, hx = kh // 2, kw // 2
    wide = planar.to(torch.int32)
    acc = 0
    for ky in range(kh):
        for kx in range(kw):
            acc = acc + int(int_mask[ky, kx]) * _tap(wide, hy, hx, ky - hy,
                                                     kx - hx)
    return _framed(_round(acc, shift), planar, hy, hx)


def conv_sep_plain(planar: torch.Tensor, row_mask: np.ndarray,
                   col_mask: np.ndarray, shift: int) -> torch.Tensor:
    """1xN pass rounded and clamped to u8, then Nx1 pass, rounded again."""
    wr, wc = np.ravel(row_mask), np.ravel(col_mask)
    n = len(wr)
    h = n // 2
    _, hp, pitch = planar.shape
    wide = planar.to(torch.int32)
    rows = 0
    for kx in range(n):
        rows = rows + int(wr[kx]) * wide[..., kx:pitch - 2 * h + kx]
    rows = _round(rows, shift)          # every padded row, interior columns
    acc = 0
    for ky in range(n):
        acc = acc + int(wc[ky]) * rows[:, ky:hp - 2 * h + ky]
    return _framed(_round(acc, shift), planar, h, h)


def blur3x3_plain(planar: torch.Tensor) -> torch.Tensor:
    """Op #14: 1-2-1 x 1-2-1 with constant weights, (o + 8) >> 4."""
    _, hp, pitch = planar.shape
    wide = planar.to(torch.int32)
    col = wide[:, 0:hp - 2] + 2 * wide[:, 1:hp - 1] + wide[:, 2:hp]
    o = (col[..., 0:pitch - 2] + 2 * col[..., 1:pitch - 1]
         + col[..., 2:pitch])
    return _framed((o + 8) >> 4, planar, 1, 1)


# -- wrappers --------------------------------------------------------------

def _launch_window(name: str, entry: str, planar: torch.Tensor,
                   *extra) -> torch.Tensor:
    out = torch.empty_like(planar)
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


def convolution(planar: torch.Tensor, int_mask: np.ndarray,
                shift: int) -> torch.Tensor:
    """Dense correlation with a runtime integer mask, 3x3 or 5x5."""
    kernels.check_planar(planar)
    kh, kw = int_mask.shape
    if kh != kw or kh not in CONV_DENSE_SIZES:
        raise ValueError(f"no dense convolution kernel for a {kh}x{kw} "
                         f"mask (square, sizes {CONV_DENSE_SIZES})")
    if kernels.on_cpu(planar):
        return conv_dense_plain(planar, int_mask, shift)
    return _launch_window(f"window_u8<ConvDense<{kh},{kw}>>",
                          "dip_conv_dense_u8", planar, kh, kw,
                          _int_array(int_mask), shift)


def convolution_separated(planar: torch.Tensor, row_mask: np.ndarray,
                          col_mask: np.ndarray, shift: int) -> torch.Tensor:
    """1xN then Nx1 correlation, each pass rounded to u8, N in {3, 5}."""
    kernels.check_planar(planar)
    n = row_mask.size
    if (row_mask.shape != (1, n) or col_mask.shape != (n, 1)
            or n not in CONV_SEP_SIZES):
        raise ValueError(f"no separable convolution kernel for masks "
                         f"{row_mask.shape} and {col_mask.shape}")
    if kernels.on_cpu(planar):
        return conv_sep_plain(planar, row_mask, col_mask, shift)
    return _launch_window(f"window_u8<ConvSep<{n}>>", "dip_conv_sep_u8",
                          planar, n, _int_array(row_mask),
                          _int_array(col_mask), shift)


def gaussian_blur_3x3(planar: torch.Tensor) -> torch.Tensor:
    kernels.check_planar(planar)
    if kernels.on_cpu(planar):
        return blur3x3_plain(planar)
    return _launch_window("window_u8<Blur3x3>", "dip_blur3x3_u8", planar)
