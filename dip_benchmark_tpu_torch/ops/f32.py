"""The ops of the float32 data model on the planar padded image.

The port of ``dip_benchmark_tpu/ops/pallas/f32.py``: the 12 device ops of
the matrix and the fused pipeline over a ``(3, Hp, pitch)`` float32 tensor
in [0, 1] (``utils.image.to_planar_padded_f32``), each returning a tensor
of the same layout. As in the uint8 model, point ops run over the whole
buffer, halo included, and windowed ops and the pipeline write 0 in their
outer ring of ``hy`` rows and ``hx`` columns (2 for the pipeline). The
erosions' plain versions are the uint8 model's (``window.erosion_plain``,
``window.erosion_sep_plain``): a min over taps is the same for any dtype.

The convolutions take any mask of 1 to 17 taps a side (N from 1 to 17
separable), anchored at ``(kh // 2, kw // 2)``: 3x3 and 5x5 (N 3, 5) on
the strip bodies of ``f32.cu``, every other shape on the tile kernels of
``csrc/conv.cu``; ``make_conv`` and ``make_conv_sep`` are the JAX
package's ``_make_conv`` and ``_make_conv_sep``, refusing a mask wider
than the layout's pad.

Each op has a wrapper that launches its CUDA kernel
(``kernels/csrc/f32.cu``) for a tensor on the card, and a plain PyTorch
version (``*_plain``) of the same whole-buffer function that the wrapper
takes only for a tensor on the CPU. The plain versions are separate torch
operations, each rounding once, in the kernels' order of operations (the
JAX kernels' order, ``f32.py``), with float32 constants; the kernels use
``__fmul_rn``/``__fadd_rn`` so that no multiply-add is contracted, and on
the card the two are equal bit for bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import spec
from ..models import pipeline
from ..runtime import tracing

from . import kernels, window

F32 = torch.float32
# The luma weights as Python floats that are exactly float32 values, so
# every torch operation and the kernel's arguments see the same numbers.
LUMA = tuple(float(np.float32(w)) for w in spec.GRAYSCALE_WEIGHTS_RGB)
# Structuring element -> (kernel name, C entry point) in f32.cu.
EROSION_KERNELS = (
    (spec.CROSS_MASK_3X3, "window_f32<MinPlus>", "dip_erosion_plus_f32"),
    (spec.SQUARE_MASK_3X3, "window_f32<MinRect>", "dip_erosion_rect_f32"),
)


# -- plain PyTorch versions ------------------------------------------------

def copy_plain(planar: torch.Tensor) -> torch.Tensor:
    return planar.clone()


def inversion_plain(planar: torch.Tensor) -> torch.Tensor:
    return 1.0 - planar


def threshold_plain(planar: torch.Tensor) -> torch.Tensor:
    return (planar > 0.5).to(F32)


def grayscale_plain(planar: torch.Tensor) -> torch.Tensor:
    """(wr * R + wg * G) + wb * B, to all three planes."""
    r, g, b = planar
    wr, wg, wb = LUMA
    gray = (r * wr + g * wg) + b * wb
    return gray.expand(3, -1, -1).contiguous()


def conv_dense_plain(planar: torch.Tensor, int_mask: np.ndarray,
                     shift: int) -> torch.Tensor:
    """For each mask column kx, the sum over ky of tap times weight; then
    the sum of those column sums over kx. No rounding to u8."""
    fmask = spec.mask_float(int_mask, shift)
    kh, kw = fmask.shape
    hy, hx = kh // 2, kw // 2
    if window._no_interior(planar, hy, hx):
        return torch.zeros_like(planar)
    acc = None
    for kx in range(kw):
        col = None
        for ky in range(kh):
            t = window._tap(planar, hy, hx, ky - hy, kx - hx) * float(
                fmask[ky, kx])
            col = t if col is None else col + t
        acc = col if acc is None else acc + col
    return window._framed(acc, planar, hy, hx)


def conv_sep_plain(planar: torch.Tensor, row_mask: np.ndarray,
                   col_mask: np.ndarray, shift: int) -> torch.Tensor:
    """1xN pass with the row mask over every padded row, then Nx1 pass
    with the column mask, no rounding between."""
    wr = np.ravel(spec.mask_float(row_mask, shift))
    wc = np.ravel(spec.mask_float(col_mask, shift))
    n = len(wr)
    h = n // 2
    if window._no_interior(planar, h, h):
        return torch.zeros_like(planar)
    _, hp, pitch = planar.shape
    rows = None
    for kx in range(n):
        t = planar[..., kx:pitch - 2 * h + kx] * float(wr[kx])
        rows = t if rows is None else rows + t
    acc = None
    for ky in range(n):
        t = rows[:, ky:hp - 2 * h + ky] * float(wc[ky])
        acc = t if acc is None else acc + t
    return window._framed(acc, planar, h, h)


def blur3x3_plain(planar: torch.Tensor) -> torch.Tensor:
    """0.25 / 0.5 / 0.25 vertically, then horizontally, each pass
    (q * a + h * b) + q * c."""
    if window._no_interior(planar, 1, 1):
        return torch.zeros_like(planar)
    _, hp, pitch = planar.shape
    q, h = 0.25, 0.5
    col = (planar[:, 0:hp - 2] * q + planar[:, 1:hp - 1] * h) \
        + planar[:, 2:hp] * q
    o = (col[..., 0:pitch - 2] * q + col[..., 1:pitch - 1] * h) \
        + col[..., 2:pitch] * q
    return window._framed(o, planar, 1, 1)


def fused_pipeline_plain(planar: torch.Tensor) -> torch.Tensor:
    """The float32 model's plain pipeline (``models.pipeline``'s, with
    this module's grayscale, threshold and blur)."""
    return pipeline.pipeline_plain(planar, grayscale_plain, threshold_plain,
                                   blur3x3_plain)


# -- wrappers --------------------------------------------------------------

def _launch_point(name: str, entry: str, planar: torch.Tensor,
                  n4: int, *extra) -> torch.Tensor:
    out = tracing.call("alloc", torch.empty_like, planar)
    kernels.launch(name, entry, planar.device, planar.data_ptr(),
                   out.data_ptr(), n4, *extra)
    return out


def _float_array(values) -> ctypes.Array:
    flat = [float(v) for v in np.ravel(values).astype(np.float32)]
    return (ctypes.c_float * len(flat))(*flat)


def copy(planar: torch.Tensor) -> torch.Tensor:
    kernels.check_planar(planar, dtype=F32)
    if kernels.on_cpu(planar):
        return copy_plain(planar)
    return _launch_point("point_f32<Copy>", "dip_copy_f32", planar,
                         planar.numel() // 4)


def inversion(planar: torch.Tensor) -> torch.Tensor:
    kernels.check_planar(planar, dtype=F32)
    if kernels.on_cpu(planar):
        return inversion_plain(planar)
    return _launch_point("point_f32<Invert>", "dip_inversion_f32", planar,
                         planar.numel() // 4)


def threshold(planar: torch.Tensor) -> torch.Tensor:
    kernels.check_planar(planar, dtype=F32)
    if kernels.on_cpu(planar):
        return threshold_plain(planar)
    return _launch_point("point_f32<Threshold>", "dip_threshold_f32", planar,
                         planar.numel() // 4)


def grayscale(planar: torch.Tensor) -> torch.Tensor:
    kernels.check_planar(planar, channels=3, dtype=F32)
    if kernels.on_cpu(planar):
        return grayscale_plain(planar)
    return _launch_point("grayscale_f32", "dip_grayscale_f32", planar,
                         planar[0].numel() // 4, *LUMA)


def erosion(planar: torch.Tensor, mask: np.ndarray) -> torch.Tensor:
    """Erosion by the 3x3 cross or square structuring element."""
    kernels.check_planar(planar, dtype=F32)
    found = [k for k in EROSION_KERNELS if np.array_equal(k[0], mask)]
    if not found:
        raise ValueError(f"no erosion kernel for the mask\n{mask}")
    if kernels.on_cpu(planar):
        return window.erosion_plain(planar, mask)
    _, name, entry = found[0]
    return window._launch_window(name, entry, planar)


def erosion_separated(planar: torch.Tensor) -> torch.Tensor:
    kernels.check_planar(planar, dtype=F32)
    if kernels.on_cpu(planar):
        return window.erosion_sep_plain(planar)
    return window._launch_window("window_f32<MinSep>",
                                 "dip_erosion_sep_f32", planar)


def convolution_launch(int_mask: np.ndarray, shift: int) -> tuple:
    """(kernel name, C entry point, its arguments after the geometry) of
    ``convolution``: the strip body ``ConvDense`` for 3x3 and 5x5, the
    tile kernel of ``csrc/conv.cu`` for every other shape."""
    kh, kw = int_mask.shape
    window.check_conv_shape(kh, kw)
    weights = _float_array(spec.mask_float(int_mask, shift))
    if kh == kw and kh in window.STRIP_CONV_SIZES:
        return (f"window_f32<ConvDense<{kh},{kw}>>", "dip_conv_dense_f32",
                (kh, kw, weights))
    return "conv_tile_dense_f32", "dip_conv_tile_dense_f32", (kh, kw, weights)


def convolution(planar: torch.Tensor, int_mask: np.ndarray,
                shift: int) -> torch.Tensor:
    """Dense correlation with the float mask int_mask / 2**shift, 1 to 17
    taps a side, anchored at ``(kh // 2, kw // 2)``."""
    kernels.check_planar(planar, dtype=F32)
    window.check_conv_shape(*int_mask.shape)
    if kernels.on_cpu(planar):
        return conv_dense_plain(planar, int_mask, shift)
    name, entry, extra = convolution_launch(int_mask, shift)
    return window._launch_window(name, entry, planar, *extra)


def convolution_separated_launch(row_mask: np.ndarray, col_mask: np.ndarray,
                                 shift: int) -> tuple:
    """(kernel name, C entry point, its arguments after the geometry) of
    ``convolution_separated``: ``ConvSep<N>`` for N 3 and 5, the tile
    kernel for every other N."""
    n = window.separable_taps(row_mask, col_mask)
    weights = (n, _float_array(spec.mask_float(row_mask, shift)),
               _float_array(spec.mask_float(col_mask, shift)))
    if n in window.STRIP_CONV_SIZES:
        return f"window_f32<ConvSep<{n}>>", "dip_conv_sep_f32", weights
    return "conv_tile_sep_f32", "dip_conv_tile_sep_f32", weights


def convolution_separated(planar: torch.Tensor, row_mask: np.ndarray,
                          col_mask: np.ndarray, shift: int) -> torch.Tensor:
    """1xN then Nx1 correlation, unrounded between, N from 1 to 17."""
    kernels.check_planar(planar, dtype=F32)
    window.separable_taps(row_mask, col_mask)
    if kernels.on_cpu(planar):
        return conv_sep_plain(planar, row_mask, col_mask, shift)
    name, entry, extra = convolution_separated_launch(row_mask, col_mask,
                                                      shift)
    return window._launch_window(name, entry, planar, *extra)


def make_conv(layout, int_mask: np.ndarray, shift: int):
    """Dense correlation with int_mask / 2**shift on the float32 ``layout``
    (the JAX package's ``_make_conv``): 1 to 17 taps a side, the mask's
    half-sizes within the layout's pad."""
    int_mask = np.asarray(int_mask)
    kh, kw = int_mask.shape
    window.check_conv_shape(kh, kw)
    window.check_radius(layout, kh // 2, kw // 2, f"{kh}x{kw} mask")
    name, entry, extra = convolution_launch(int_mask, shift)
    return window.layout_op(
        layout, F32, name, lambda p: conv_dense_plain(p, int_mask, shift),
        lambda p: window._launch_window(name, entry, p, *extra))


def make_conv_sep(layout, n: int, row_mask: np.ndarray, shift: int):
    """The 1xN pass, then the Nx1 pass, unrounded between, with the one
    mask ``row_mask`` (n weights) over 2**shift for both (the JAX
    package's ``_make_conv_sep``); N from 1 to 17, N // 2 within the
    layout's pad."""
    row, col = window.separable_pair(layout, n, row_mask)
    name, entry, extra = convolution_separated_launch(row, col, shift)
    return window.layout_op(
        layout, F32, name, lambda p: conv_sep_plain(p, row, col, shift),
        lambda p: window._launch_window(name, entry, p, *extra))


def gaussian_blur_3x3(planar: torch.Tensor) -> torch.Tensor:
    kernels.check_planar(planar, dtype=F32)
    if kernels.on_cpu(planar):
        return blur3x3_plain(planar)
    return window._launch_window("window_f32<Blur3x3>", "dip_blur3x3_f32",
                                 planar)


def make_erosion(layout, taps):
    """Min over any structuring element ``taps`` on the float32 layout
    (the JAX package's ``_make_erosion``), routed as
    ``window.make_morphology`` routes the uint8 one."""
    return window.make_morphology(layout, taps, "min", "float32")


def fused_pipeline(planar: torch.Tensor) -> torch.Tensor:
    """Grayscale, threshold, 3x3 square erosion and blur in one launch,
    on one image ``(3, Hp, pitch)`` or a stack ``(B, 3, Hp, pitch)``."""
    kernels.check_planar(planar, channels=3, batched=True, dtype=F32)
    if kernels.on_cpu(planar):
        return fused_pipeline_plain(planar)
    out = tracing.call("alloc", torch.empty_like, planar)
    batch = planar.shape[0] if planar.dim() == 4 else 1
    _, hp, pitch = planar.shape[-3:]
    kernels.launch("pipeline_f32", "dip_pipeline_f32", planar.device,
                   planar.data_ptr(), out.data_ptr(), batch, hp, pitch,
                   *LUMA)
    return out
