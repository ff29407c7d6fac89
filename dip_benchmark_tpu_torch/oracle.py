"""Pure-NumPy golden implementations of the 14-op matrix.

The port's own copy of ``dip_benchmark_tpu/oracle.py``; a test holds it
equal to the JAX package's oracle. ``--verify`` checks against it where
the native C++ oracle (``native/``, held equal to it) does not build.

These are the *specification*, not a fast path: every accelerated
implementation (the CUDA kernels and their plain PyTorch versions) must
match these bit-for-bit on uint8 HWC RGB images. Semantics come from spec,
distilled from the reference backends (SURVEY.md §2). The reference repo has no
tests (SURVEY.md §4); this oracle is the mutual-oracle role its five redundant
backends played, made executable.

All functions take/return uint8 arrays of shape (H, W, C) with C=3 (RGB).
"""

from __future__ import annotations

import numpy as np

from . import spec


def _check(image: np.ndarray) -> None:
    assert image.dtype == np.uint8, image.dtype
    assert image.ndim == 3 and image.shape[2] == 3, image.shape


# ---------------------------------------------------------------------------
# Point ops
# ---------------------------------------------------------------------------

def inversion(image: np.ndarray) -> np.ndarray:
    """[reference: sycl/benchmark.cpp:54-68] out = 255 - in."""
    _check(image)
    return (255 - image.astype(np.int32)).astype(np.uint8)


def grayscale(image: np.ndarray) -> np.ndarray:
    """Rec.709 luma in exact 16-bit fixed point, truncate, replicate.

    The reference computes this in float32 [sycl/benchmark.cpp:71-91]; the
    framework spec uses the integer-exact formulation instead so every
    backend is bit-identical regardless of FMA contraction (spec module
    docstring).
    """
    _check(image)
    r = image[..., 0].astype(np.int32)
    g = image[..., 1].astype(np.int32)
    b = image[..., 2].astype(np.int32)
    nr, ng, nb = spec.GRAYSCALE_WEIGHTS_INT_RGB
    gray = (nr * r + ng * g + nb * b) >> spec.GRAYSCALE_SHIFT
    gray_u8 = gray.astype(np.uint8)
    return np.repeat(gray_u8[..., None], 3, axis=2)


def threshold(image: np.ndarray) -> np.ndarray:
    """[reference: sycl/benchmark.cpp:94-114] out = 255 if in > 127 else 0."""
    _check(image)
    return np.where(image > spec.THRESHOLD_VALUE,
                    np.uint8(spec.THRESHOLD_MAX), np.uint8(0))


# ---------------------------------------------------------------------------
# Border handling: build padded image with SYCL-parity mirror halo
# ---------------------------------------------------------------------------

def mirror_pad(image: np.ndarray, pad_y: int, pad_x: int) -> np.ndarray:
    """Pad H/W dims with spec.mirror_index semantics (low: -i, high: 2n-i-1)."""
    h, w = image.shape[:2]
    ys = spec.mirror_index(np.arange(-pad_y, h + pad_y), h)
    xs = spec.mirror_index(np.arange(-pad_x, w + pad_x), w)
    return image[np.ix_(ys, xs)]


# ---------------------------------------------------------------------------
# Windowed ops
# ---------------------------------------------------------------------------

def erosion(image: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Per-channel min over the structuring element, mirror borders.

    [reference: sycl/benchmark.cpp:116-157]
    """
    _check(image)
    mh, mw = mask.shape
    py, px = mh // 2, mw // 2
    padded = mirror_pad(image, py, px)
    h, w = image.shape[:2]
    out = np.full_like(image, 255)
    for my in range(mh):
        for mx in range(mw):
            if not mask[my, mx]:
                continue
            window = padded[my:my + h, mx:mx + w]
            out = np.minimum(out, window)
    return out


def dilation(image: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Per-channel max over the structuring element, mirror borders.

    The reference defines (but never benchmarks) separable dilation helpers
    [opencv/benchmark.py:80-82]; provided here for library completeness.
    """
    _check(image)
    mh, mw = mask.shape
    padded = mirror_pad(image, mh // 2, mw // 2)
    h, w = image.shape[:2]
    out = np.zeros_like(image)
    for my in range(mh):
        for mx in range(mw):
            if not mask[my, mx]:
                continue
            out = np.maximum(out, padded[my:my + h, mx:mx + w])
    return out


def dilation_separated(image: np.ndarray) -> np.ndarray:
    """[reference: opencv/benchmark.py:80-82]"""
    aux = dilation(image, spec.SQUARE_MASK_1X3)
    return dilation(aux, spec.SQUARE_MASK_3X1)


def erosion_separated(image: np.ndarray) -> np.ndarray:
    """1x3 then 3x1 square erosion through an aux buffer.

    [reference: opencv/benchmark.py:76-78, sycl/benchmark.cpp:341-344]
    """
    aux = erosion(image, spec.SQUARE_MASK_1X3)
    return erosion(aux, spec.SQUARE_MASK_3X1)


def convolution(image: np.ndarray, int_mask: np.ndarray, shift: int) -> np.ndarray:
    """Integer-exact Gaussian correlation, round-half-up, mirror borders.

    Equivalent to the reference's float32 accumulate + int(sum+0.5) + clamp
    because the weights are exact binary fractions (see spec docstring).
    [reference: sycl/benchmark.cpp:159-202]
    """
    _check(image)
    kh, kw = int_mask.shape
    py, px = kh // 2, kw // 2
    padded = mirror_pad(image, py, px).astype(np.int32)
    h, w = image.shape[:2]
    acc = np.zeros(image.shape, dtype=np.int32)
    for ky in range(kh):
        for kx in range(kw):
            acc += int_mask[ky, kx] * padded[ky:ky + h, kx:kx + w]
    half = 1 << (shift - 1)
    result = (acc + half) >> shift
    return np.clip(result, 0, 255).astype(np.uint8)


def convolution_3x3(image: np.ndarray) -> np.ndarray:
    return convolution(image, spec.BLUR_3X3_INT, spec.BLUR_3X3_SHIFT)


def convolution_3x3_separated(image: np.ndarray) -> np.ndarray:
    """Horizontal 1x3 pass into aux, vertical 3x1 pass aux -> out.

    [reference: opencv/benchmark.py:84-86, sycl/benchmark.cpp:347-351]
    """
    aux = convolution(image, spec.BLUR_1X3_INT, spec.BLUR_SEP3_SHIFT)
    return convolution(aux, spec.BLUR_3X1_INT, spec.BLUR_SEP3_SHIFT)


def convolution_5x5(image: np.ndarray) -> np.ndarray:
    return convolution(image, spec.BLUR_5X5_INT, spec.BLUR_5X5_SHIFT)


def convolution_5x5_separated(image: np.ndarray) -> np.ndarray:
    aux = convolution(image, spec.BLUR_1X5_INT, spec.BLUR_SEP5_SHIFT)
    return convolution(aux, spec.BLUR_5X1_INT, spec.BLUR_SEP5_SHIFT)


def gaussian_blur_3x3(image: np.ndarray) -> np.ndarray:
    """Op #14: the 'library-native' blur. Semantically identical to
    convolution_3x3 (the hand-written-kernel backends hardcode the same mask);
    the benchmark measures the specialization benefit, not a different result.
    [reference: sycl/benchmark.cpp:204-252, cuda/benchmark.jl:105-133]
    """
    return convolution_3x3(image)


# ---------------------------------------------------------------------------
# Fused flagship pipeline (BASELINE.json config 5)
# ---------------------------------------------------------------------------

def fused_pipeline(image: np.ndarray) -> np.ndarray:
    """grayscale -> threshold -> erosion(3x3 square) -> gaussian blur 3x3."""
    return gaussian_blur_3x3(erosion(threshold(grayscale(image)),
                                     spec.SQUARE_MASK_3X3))


# Registry keyed by CSV column name for the 12 image-producing ops.
IMAGE_OPS = {
    "Copy": lambda im: im.copy(),
    "Inversion": inversion,
    "Grayscale": grayscale,
    "Threshold": threshold,
    "Erosion-3x3-Cross": lambda im: erosion(im, spec.CROSS_MASK_3X3),
    "Erosion-3x3-Square": lambda im: erosion(im, spec.SQUARE_MASK_3X3),
    "Erosion-1x3+3x1-Square": erosion_separated,
    "Convolution-3x3": convolution_3x3,
    "Convolution-1x3+3x1": convolution_3x3_separated,
    "Convolution-5x5": convolution_5x5,
    "Convolution-1x5+5x1": convolution_5x5_separated,
    "Gaussian-Blur-3x3": gaussian_blur_3x3,
    # Extra (non-reference) row: the flagship fused chain, for --pipeline.
    "Fused-Pipeline": fused_pipeline,
}
