"""NumPy golden implementations for the float32 data-model variant.

The port's own copy of ``dip_benchmark_tpu/oracle_f32.py``; a test holds it
equal to the JAX package's at tolerance 0. It is what ``--verify --dtype
float32`` checks against.

The reference CUDA.jl backend uses planar-CHW float32 in [0,1]
[cuda/benchmark.jl:171-179]; SURVEY.md §2.3 lists that data model as a
config knob worth supporting. Semantics here follow CUDA.jl where it is
correct and the 4-of-5 consensus where it is buggy:

- inversion: 1.0f - x                     [cuda/benchmark.jl:17]
- grayscale: Rec.709 luma, replicated      [cuda/benchmark.jl:27-30]
- threshold: x > 0.5 -> 1.0 else 0.0       [cuda/benchmark.jl:34-40]
- erosion: true min over the structuring element (NOT the reference's
  accumulating-sum bug, SURVEY.md §2.4.2), mirror borders (NOT its
  skip-out-of-bounds border, §2.3 — one consistent border rule per build)
- convolution: f32 MAC with the normalized float masks, no rounding
  (values stay in [0,1])                   [cuda/benchmark.jl:81-103]

All functions take/return float32 (C, H, W) planar arrays in [0,1].
"""

from __future__ import annotations

import numpy as np

from . import spec


def _check(x: np.ndarray) -> None:
    assert x.dtype == np.float32 and x.ndim == 3 and x.shape[0] == 3, (
        x.dtype, x.shape)


def from_uint8_hwc(image: np.ndarray) -> np.ndarray:
    """uint8 HWC -> float32 CHW in [0,1] (the CUDA.jl load path:
    channelview + Float32, cuda/benchmark.jl:171-172)."""
    return (np.transpose(image, (2, 0, 1)).astype(np.float32)
            / np.float32(255.0))


def to_uint8_hwc(x: np.ndarray) -> np.ndarray:
    """float32 CHW [0,1] -> uint8 HWC, round-to-nearest with clamp (the
    N0f8 conversion Images.jl applies on save, cuda/benchmark.jl:271)."""
    v = np.clip(np.rint(x * np.float32(255.0)), 0, 255).astype(np.uint8)
    return np.transpose(v, (1, 2, 0))


def inversion(x: np.ndarray) -> np.ndarray:
    _check(x)
    return np.float32(1.0) - x


def grayscale(x: np.ndarray) -> np.ndarray:
    _check(x)
    wr, wg, wb = (np.float32(w) for w in spec.GRAYSCALE_WEIGHTS_RGB)
    gray = wr * x[0] + wg * x[1] + wb * x[2]
    return np.broadcast_to(gray, x.shape).copy()


def threshold(x: np.ndarray) -> np.ndarray:
    _check(x)
    return np.where(x > np.float32(0.5), np.float32(1.0), np.float32(0.0))


def _mirror_pad(x: np.ndarray, py: int, px: int) -> np.ndarray:
    h, w = x.shape[1:]
    ys = spec.mirror_index(np.arange(-py, h + py), h)
    xs = spec.mirror_index(np.arange(-px, w + px), w)
    return x[:, ys[:, None], xs[None, :]]


def erosion(x: np.ndarray, mask: np.ndarray) -> np.ndarray:
    _check(x)
    mh, mw = mask.shape
    py, px = mh // 2, mw // 2
    padded = _mirror_pad(x, py, px)
    h, w = x.shape[1:]
    out = np.full_like(x, np.float32(np.inf))
    for my in range(mh):
        for mx in range(mw):
            if not mask[my, mx]:
                continue
            out = np.minimum(out, padded[:, my:my + h, mx:mx + w])
    return out.astype(np.float32)


def erosion_separated(x: np.ndarray) -> np.ndarray:
    return erosion(erosion(x, spec.SQUARE_MASK_1X3), spec.SQUARE_MASK_3X1)


def convolution(x: np.ndarray, int_mask: np.ndarray, shift: int) -> np.ndarray:
    """f32 MAC with the normalized mask (weight = int/2^shift, exact).

    Accumulation order is column-sums-then-columns, the order the JAX
    package's three f32 implementations share and the port's kernels and
    plain versions keep. f32 reassociation changes results by ulps only
    (reference backends are not bit-identical to each other either,
    SURVEY.md §2.1)."""
    _check(x)
    fmask = spec.mask_float(int_mask, shift)
    kh, kw = fmask.shape
    padded = _mirror_pad(x, kh // 2, kw // 2)
    h, w = x.shape[1:]
    acc = np.zeros_like(x)
    for kx in range(kw):
        col = np.zeros_like(x)
        for ky in range(kh):
            col += fmask[ky, kx] * padded[:, ky:ky + h, kx:kx + w]
        acc += col
    return acc.astype(np.float32)


IMAGE_OPS_F32 = {
    "Copy": lambda x: x.copy(),
    "Inversion": inversion,
    "Grayscale": grayscale,
    "Threshold": threshold,
    "Erosion-3x3-Cross": lambda x: erosion(x, spec.CROSS_MASK_3X3),
    "Erosion-3x3-Square": lambda x: erosion(x, spec.SQUARE_MASK_3X3),
    "Erosion-1x3+3x1-Square": erosion_separated,
    "Convolution-3x3": lambda x: convolution(
        x, spec.BLUR_3X3_INT, spec.BLUR_3X3_SHIFT),
    "Convolution-1x3+3x1": lambda x: convolution(
        convolution(x, spec.BLUR_1X3_INT, spec.BLUR_SEP3_SHIFT),
        spec.BLUR_3X1_INT, spec.BLUR_SEP3_SHIFT),
    "Convolution-5x5": lambda x: convolution(
        x, spec.BLUR_5X5_INT, spec.BLUR_5X5_SHIFT),
    "Convolution-1x5+5x1": lambda x: convolution(
        convolution(x, spec.BLUR_1X5_INT, spec.BLUR_SEP5_SHIFT),
        spec.BLUR_5X1_INT, spec.BLUR_SEP5_SHIFT),
    "Gaussian-Blur-3x3": lambda x: convolution(
        x, spec.BLUR_3X3_INT, spec.BLUR_3X3_SHIFT),
    "Fused-Pipeline": lambda x: convolution(
        erosion(threshold(grayscale(x)), spec.SQUARE_MASK_3X3),
        spec.BLUR_3X3_INT, spec.BLUR_3X3_SHIFT),
}


# A computed f32 value within a few ulps of the 0.5 threshold step can
# legitimately flip under another association of the producing MAC (the
# model pins float-precision agreement, not bit equality through a step
# discontinuity — convolution() docstring). 4 ulps at 0.5.
THRESHOLD_ULP_SLACK = np.float32(2 ** -22)


def near_threshold_mask(x: np.ndarray) -> np.ndarray:
    """(C, H, W) f32 -> (H, W) bool: pixels where any channel sits within
    THRESHOLD_ULP_SLACK of the 0.5 threshold step."""
    return (np.abs(x - np.float32(0.5)) <= THRESHOLD_ULP_SLACK).any(axis=0)


def dilate_mask(m: np.ndarray, ry: int, rx: int) -> np.ndarray:
    """Box-dilate an (H, W) bool mask by (ry, rx) — the spatial spread
    the stages after a threshold give a flipped pixel."""
    if (ry == 0 and rx == 0) or not m.any():
        return m
    padded = np.pad(m, ((ry, ry), (rx, rx)), mode="edge")
    h, w = m.shape
    acc = np.zeros_like(m)
    for dy in range(2 * ry + 1):
        for dx in range(2 * rx + 1):
            acc |= padded[dy:dy + h, dx:dx + w]
    return acc


def uint8_verify_ops() -> dict:
    """uint8-HWC-in / uint8-HWC-out verify dict for the f32 data model.
    Fused-Pipeline returns (expected, dontcare-mask) when
    threshold-boundary pixels exist: its Threshold stage runs on a
    COMPUTED luma, so a luma within ulps of the 0.5 step may flip {0,1}
    between this oracle's association order and the device's, and
    erosion+blur then spread the flip (radius 2) — differences there are
    not defects. Everywhere else the session's atol-1 contract applies
    unchanged (the harness unpacks the tuple)."""
    def wrap(col):
        fn = IMAGE_OPS_F32[col]
        if col != "Fused-Pipeline":
            return lambda im: to_uint8_hwc(fn(from_uint8_hwc(im)))

        def pipeline(im):
            x = from_uint8_hwc(im)
            expected = to_uint8_hwc(fn(x))
            mask = near_threshold_mask(grayscale(x)[:1])
            if not mask.any():
                return expected
            mask = dilate_mask(mask, 2, 2)
            return expected, np.broadcast_to(mask[..., None],
                                             expected.shape)
        return pipeline

    return {col: wrap(col) for col in IMAGE_OPS_F32}
