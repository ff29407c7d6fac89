"""The library-call path of the uint8 model: the 13 on-device ops as plain
PyTorch tensor calls, no hand-written kernel.

The port of ``dip_benchmark_tpu/ops/xla.py``, the analogue of the reference
suite's library-call backends (OpenCV's T-API, MATLAB's gpuArray). Every
function takes a uint8 ``(H, W, 3)`` image, or a ``(B, H, W, 3)`` stack,
and returns the same layout; each mirror-pads inside the op, so the pad is
part of the timed work, as in the reference. The results equal
``oracle.py`` bit for bit.

No single PyTorch call computes these ops on uint8 on the card:
``F.conv2d`` neither runs on uint8 nor rounds, and the CUDA
``max_pool2d`` refuses uint8. So the erosions are a min over shifted
slices, and the convolutions an int32 multiply-accumulate over shifted
slices with ``(acc + half) >> shift`` and a clamp, the reference's exact
forms (``xla.py:100-202``). The reference's flat ``(H, W*3)``
coefficient rows for Grayscale and the fused pipeline work around a TPU
relayout; here the luma is three int32 multiplies on the channels, and
the pipeline the composed stages on one channel, with the same integers.
"""

from __future__ import annotations

import torch

from .. import spec

_H, _W = -3, -2  # the image dims of (..., H, W, C)


def mirror_pad(x: torch.Tensor, pad_y: int, pad_x: int) -> torch.Tensor:
    """SYCL-parity mirror pad (low: -i, high: 2n-i-1) of the H and W dims
    of ``(..., H, W, C)``."""
    if pad_y:
        top = x[..., 1:pad_y + 1, :, :].flip(_H)
        bot = x[..., -pad_y:, :, :].flip(_H)
        x = torch.cat([top, x, bot], dim=_H)
    if pad_x:
        left = x[..., 1:pad_x + 1, :].flip(_W)
        right = x[..., -pad_x:, :].flip(_W)
        x = torch.cat([left, x, right], dim=_W)
    return x


def _shifted(p: torch.Tensor, dy: int, dx: int, h: int,
             w: int) -> torch.Tensor:
    return p[..., dy:dy + h, dx:dx + w, :]


# ---------------------------------------------------------------------------
# Point ops
# ---------------------------------------------------------------------------

def copy(x: torch.Tensor) -> torch.Tensor:
    """A device-to-device copy (the reference's cudaMemcpy D2D)."""
    return x.clone()


def inversion(x: torch.Tensor) -> torch.Tensor:
    return 255 - x


def _luma(x: torch.Tensor) -> torch.Tensor:
    """Fixed-point Rec.709 luma of ``(..., H, W, 3)``, truncated, as a uint8
    ``(..., H, W, 1)``."""
    wr, wg, wb = spec.GRAYSCALE_WEIGHTS_INT_RGB
    xi = x.to(torch.int32)
    acc = xi[..., 0:1] * wr + xi[..., 1:2] * wg + xi[..., 2:3] * wb
    return (acc >> spec.GRAYSCALE_SHIFT).to(torch.uint8)


def grayscale(x: torch.Tensor) -> torch.Tensor:
    return _luma(x).expand_as(x).contiguous()


def threshold(x: torch.Tensor) -> torch.Tensor:
    return (x > spec.THRESHOLD_VALUE).to(torch.uint8).mul_(
        spec.THRESHOLD_MAX)


# ---------------------------------------------------------------------------
# Erosion: a min over shifted slices of the padded image
# ---------------------------------------------------------------------------

def _min_slices(p: torch.Tensor, offs, h: int, w: int) -> torch.Tensor:
    acc = None
    for dy, dx in offs:
        t = _shifted(p, dy, dx, h, w)
        acc = t if acc is None else torch.minimum(acc, t)
    return acc


def erosion_square(x: torch.Tensor) -> torch.Tensor:
    """Separable: a min of 3 rows, then of 3 columns (exact)."""
    h, w = x.shape[_H], x.shape[_W]
    p = mirror_pad(x, 1, 1)
    rows = _min_slices(p, [(0, 0), (1, 0), (2, 0)], h, w + 2)
    return _min_slices(rows, [(0, 0), (0, 1), (0, 2)], h, w)


def erosion_cross(x: torch.Tensor) -> torch.Tensor:
    """The centre column's 3 slices, then the centre row's other 2."""
    h, w = x.shape[_H], x.shape[_W]
    p = mirror_pad(x, 1, 1)
    vert = _min_slices(p, [(0, 1), (1, 1), (2, 1)], h, w)
    return torch.minimum(vert, _min_slices(p, [(1, 0), (1, 2)], h, w))


def erosion_separated(x: torch.Tensor) -> torch.Tensor:
    """A 1x3 pass, then a 3x1 pass that mirrors the first pass's borders
    again (the reference's two-dispatch chain)."""
    h, w = x.shape[_H], x.shape[_W]
    aux = _min_slices(mirror_pad(x, 0, 1), [(0, 0), (0, 1), (0, 2)], h, w)
    return _min_slices(mirror_pad(aux, 1, 0), [(0, 0), (1, 0), (2, 0)], h, w)


# ---------------------------------------------------------------------------
# Convolution: int32 multiply-accumulate, round half up, clamp
# ---------------------------------------------------------------------------

def _conv(x: torch.Tensor, int_mask, shift: int) -> torch.Tensor:
    kh, kw = int_mask.shape
    h, w = x.shape[_H], x.shape[_W]
    p = mirror_pad(x, kh // 2, kw // 2).to(torch.int32)
    acc = None
    for ky in range(kh):
        for kx in range(kw):
            m = int(int_mask[ky, kx])
            if m == 0:
                continue
            t = _shifted(p, ky, kx, h, w)
            acc = t * m if acc is None else acc.add_(t, alpha=m)
    acc = (acc + (1 << (shift - 1))) >> shift
    return acc.clamp_(0, 255).to(torch.uint8)


def convolution_3x3(x: torch.Tensor) -> torch.Tensor:
    return _conv(x, spec.BLUR_3X3_INT, spec.BLUR_3X3_SHIFT)


def convolution_3x3_separated(x: torch.Tensor) -> torch.Tensor:
    aux = _conv(x, spec.BLUR_1X3_INT, spec.BLUR_SEP3_SHIFT)
    return _conv(aux, spec.BLUR_3X1_INT, spec.BLUR_SEP3_SHIFT)


def convolution_5x5(x: torch.Tensor) -> torch.Tensor:
    return _conv(x, spec.BLUR_5X5_INT, spec.BLUR_5X5_SHIFT)


def convolution_5x5_separated(x: torch.Tensor) -> torch.Tensor:
    aux = _conv(x, spec.BLUR_1X5_INT, spec.BLUR_SEP5_SHIFT)
    return _conv(aux, spec.BLUR_5X1_INT, spec.BLUR_SEP5_SHIFT)


def gaussian_blur_3x3(x: torch.Tensor) -> torch.Tensor:
    """Op #14: on the library path the same call as Convolution-3x3."""
    return convolution_3x3(x)


def fused_pipeline(x: torch.Tensor) -> torch.Tensor:
    """Grayscale -> threshold -> erosion 3x3 -> blur 3x3 on the one luma
    channel, replicated to three at the end: the stages the oracle
    composes, each with its own mirror pad."""
    v = threshold(_luma(x))
    y = gaussian_blur_3x3(erosion_square(v))
    return y.expand_as(x).contiguous()


# CSV column -> op, the 12 on-device ops of the matrix and the pipeline
# (Upload and Download belong to the session).
IMAGE_OPS = {
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
