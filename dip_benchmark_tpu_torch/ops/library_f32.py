"""The library-call path of the float32 model: the 13 on-device ops as
PyTorch library calls on the ``(3, H, W)`` float32 CHW image in [0, 1].

The port of ``dip_benchmark_tpu/ops/xla_f32.py``, with its semantics
(``oracle_f32``): each op mirror-pads inside the call, as the reference
does. Where a library call exists for float32 it is used: one depthwise
``F.conv2d`` per pass for the convolutions and the blur, and
``max_pool2d`` of the negated image for the erosions (negation is exact,
so the max of the negation is the min window). The convolutions sum in
another order than the reference's column-sums-then-columns, so they
agree with it within float32 rounding, not bit for bit.

The caller keeps TF32 off (``session.BenchmarkSession`` does it when it
builds a library-path session): cuDNN's default TF32 keeps 10 bits of
mantissa, which breaks the exact binary fractions of ``spec.mask_float``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import spec

_H, _W = -2, -1  # the image dims of (..., H, W)


def mirror_pad_chw(x: torch.Tensor, py: int, px: int) -> torch.Tensor:
    """SYCL-parity mirror pad (low: -i, high: 2n-i-1) of the H and W dims
    of ``(..., H, W)``."""
    if py:
        top = x[..., 1:py + 1, :].flip(_H)
        bot = x[..., -py:, :].flip(_H)
        x = torch.cat([top, x, bot], dim=_H)
    if px:
        left = x[..., 1:px + 1].flip(_W)
        right = x[..., -px:].flip(_W)
        x = torch.cat([left, x, right], dim=_W)
    return x


def copy(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


def inversion(x: torch.Tensor) -> torch.Tensor:
    return 1.0 - x


def grayscale(x: torch.Tensor) -> torch.Tensor:
    wr, wg, wb = spec.GRAYSCALE_WEIGHTS_RGB
    gray = x[..., 0:1, :, :] * wr + x[..., 1:2, :, :] * wg + (
        x[..., 2:3, :, :] * wb)
    return gray.expand_as(x).contiguous()


def threshold(x: torch.Tensor) -> torch.Tensor:
    return (x > 0.5).to(torch.float32)


def _erode_window(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    padded = mirror_pad_chw(x, kh // 2, kw // 2)
    return -F.max_pool2d(-padded, (kh, kw), stride=1)


def erosion_cross(x: torch.Tensor) -> torch.Tensor:
    return torch.minimum(_erode_window(x, 1, 3), _erode_window(x, 3, 1))


def erosion_square(x: torch.Tensor) -> torch.Tensor:
    return _erode_window(x, 3, 3)


def erosion_separated(x: torch.Tensor) -> torch.Tensor:
    return _erode_window(_erode_window(x, 1, 3), 3, 1)


@functools.lru_cache(maxsize=32)
def _weight(shape: tuple, data: bytes, shift: int,
            device: torch.device) -> torch.Tensor:
    """The depthwise ``(3, 1, kh, kw)`` weight of an integer mask on
    ``device``, made once: a copy to the card inside a captured graph
    would break the capture."""
    fmask = spec.mask_float(np.frombuffer(data, np.int32).reshape(shape),
                            shift).astype(np.float32)
    w = torch.from_numpy(np.ascontiguousarray(fmask))
    return w.expand(3, 1, *shape).contiguous().to(device)


def _conv(x: torch.Tensor, int_mask: np.ndarray, shift: int) -> torch.Tensor:
    """One depthwise ``F.conv2d`` (a correlation, as the reference's slice
    sum) on the mirror-padded image."""
    mask = np.ascontiguousarray(int_mask, np.int32)
    kh, kw = mask.shape
    w = _weight(mask.shape, mask.tobytes(), shift, x.device)
    padded = mirror_pad_chw(x, kh // 2, kw // 2)
    batched = padded.dim() == 4
    out = F.conv2d(padded if batched else padded[None], w, groups=3)
    return out if batched else out[0]


def convolution_3x3(x: torch.Tensor) -> torch.Tensor:
    return _conv(x, spec.BLUR_3X3_INT, spec.BLUR_3X3_SHIFT)


def convolution_3x3_separated(x: torch.Tensor) -> torch.Tensor:
    return _conv(_conv(x, spec.BLUR_1X3_INT, spec.BLUR_SEP3_SHIFT),
                 spec.BLUR_3X1_INT, spec.BLUR_SEP3_SHIFT)


def convolution_5x5(x: torch.Tensor) -> torch.Tensor:
    return _conv(x, spec.BLUR_5X5_INT, spec.BLUR_5X5_SHIFT)


def convolution_5x5_separated(x: torch.Tensor) -> torch.Tensor:
    return _conv(_conv(x, spec.BLUR_1X5_INT, spec.BLUR_SEP5_SHIFT),
                 spec.BLUR_5X1_INT, spec.BLUR_SEP5_SHIFT)


def gaussian_blur_3x3(x: torch.Tensor) -> torch.Tensor:
    return convolution_3x3(x)


def fused_pipeline(x: torch.Tensor) -> torch.Tensor:
    return gaussian_blur_3x3(erosion_square(threshold(grayscale(x))))


IMAGE_OPS_F32 = {
    "Copy": copy,
    "Inversion": inversion,
    "Grayscale": grayscale,
    "Threshold": threshold,
    "Erosion-3x3-Cross": erosion_cross,
    "Erosion-3x3-Square": erosion_square,
    "Erosion-1x3+3x1-Square": erosion_separated,
    "Convolution-3x3": convolution_3x3,
    "Convolution-1x3+3x1": convolution_3x3_separated,
    "Convolution-5x5": convolution_5x5,
    "Convolution-1x5+5x1": convolution_5x5_separated,
    "Gaussian-Blur-3x3": gaussian_blur_3x3,
    "Fused-Pipeline": fused_pipeline,
}
