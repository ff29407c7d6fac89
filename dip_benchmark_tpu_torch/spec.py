"""Canonical operation semantics for the DIP benchmark matrix.

The port's own copy of ``dip_benchmark_tpu/spec.py`` (NumPy only); a test
holds every public constant equal to the JAX package's.

This module is the single source of truth for the *specification* of the 14
benchmark operations, distilled from the 4-of-5 consensus of the reference
backends (see SURVEY.md §2.1/§2.3):

- dtype/layout: uint8 RGB, HWC at the framework edges (planar CHW inside the
  kernel path).
- Grayscale: Rec.709 luma, truncated to uint8, replicated to all 3 channels.
  Computed in EXACT 16-bit fixed point: y = (13933*R + 46871*G + 4732*B)>>16
  (weights round(w * 2^16); they sum to exactly 2^16, so flat colors map to
  themselves). Rationale — the same as the convolution ops' integer
  formulation below: the reference computes luma in float32
  ((0.0722*B + 0.7152*G) + 0.2126*R, truncating cast,
  benchmarks/sycl/benchmark.cpp:71-91, benchmarks/cuda/benchmark.jl:22-30),
  but 0.2126/0.7152/0.0722 are NOT exact binary fractions, so the float
  result depends on each compiler's FMA-contraction choices: XLA:CPU's
  contraction flips ~0.002% of pixels by one level vs a plain-NumPy
  evaluation of the identical expression (measured,
  benchmarks/tuning/xla_gray_lab.py), and the GPU reference backends have
  the same ambiguity among themselves (they already disagree: OpenCV/MATLAB
  use Rec.601). A portable bit-exact contract therefore requires an
  integer spec. The fixed-point result differs from the reference's f32
  path by at most 1 level on boundary pixels (<0.01%); all products and
  partial sums stay < 2^24, so kernels may use i32 OR f32 arithmetic and
  remain exact.
- Threshold: out = 255 if in > 127 else 0, per channel.
  [reference: benchmarks/sycl/benchmark.cpp:94-114]
- Inversion: out = 255 - in. [reference: benchmarks/sycl/benchmark.cpp:54-68]
- Erosion: per-channel min over the structuring element (true min-erosion;
  the CUDA.jl backend's accumulating-sum variant is a known reference bug,
  SURVEY.md §2.4.2). [reference: benchmarks/sycl/benchmark.cpp:116-157]
- Convolution: correlation with binomial Gaussian masks, float32 accumulate,
  round-half-up `int(sum + 0.5)`, clamp to [0, 255]. Because all mask weights
  are exact binary fractions (k/16, k/256) and uint8 inputs are small, the
  float32 result is EXACT, so an integer formulation
  `(sum_int + half) >> shift` is bit-identical and is what the kernels
  use. [reference: benchmarks/sycl/benchmark.cpp:159-202]
- Border handling: SYCL-parity mirror — index i < 0 maps to -i (reflect-101
  on the low edge); i >= n maps to 2n - i - 1 (symmetric on the high edge).
  [reference: benchmarks/sycl/benchmark.cpp:143-146,183-186]
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Point-op constants
# ---------------------------------------------------------------------------

THRESHOLD_VALUE = 127  # out = 255 if px > 127 else 0
THRESHOLD_MAX = 255

# Rec.709 luma weights in (R, G, B) order. SYCL accumulates B, then G, then R.
# Used by the float32 data model (the CUDA.jl-parity [0,1] variant), which
# keeps the reference's float semantics.
GRAYSCALE_WEIGHTS_RGB = (0.2126, 0.7152, 0.0722)

# The uint8 model's EXACT fixed-point luma (module docstring): numerators
# round(w * 2^16); sum == 2^16 exactly. y = (nr*R + ng*G + nb*B) >> 16.
GRAYSCALE_WEIGHTS_INT_RGB = (13933, 46871, 4732)
GRAYSCALE_SHIFT = 16
assert sum(GRAYSCALE_WEIGHTS_INT_RGB) == 1 << GRAYSCALE_SHIFT

# ---------------------------------------------------------------------------
# Structuring elements (erosion)
# [reference: benchmarks/opencv/benchmark.py:46-49, sycl/benchmark.cpp:266-288]
# ---------------------------------------------------------------------------

CROSS_MASK_3X3 = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], dtype=bool)
SQUARE_MASK_3X3 = np.ones((3, 3), dtype=bool)
SQUARE_MASK_1X3 = np.ones((1, 3), dtype=bool)
SQUARE_MASK_3X1 = np.ones((3, 1), dtype=bool)

# ---------------------------------------------------------------------------
# Gaussian convolution masks, stored as INTEGER numerators plus a shift so
# kernels can use exact integer arithmetic. weight = numerator / (1 << shift).
# [reference: benchmarks/opencv/benchmark.py:51-72, sycl/benchmark.cpp:290-318]
# ---------------------------------------------------------------------------

BLUR_3X3_INT = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], dtype=np.int32)
BLUR_3X3_SHIFT = 4  # /16

BLUR_1X3_INT = np.array([[1, 2, 1]], dtype=np.int32)
BLUR_3X1_INT = np.array([[1], [2], [1]], dtype=np.int32)
BLUR_SEP3_SHIFT = 2  # /4

BLUR_5X5_INT = np.outer([1, 4, 6, 4, 1], [1, 4, 6, 4, 1]).astype(np.int32)
BLUR_5X5_SHIFT = 8  # /256

BLUR_1X5_INT = np.array([[1, 4, 6, 4, 1]], dtype=np.int32)
BLUR_5X1_INT = np.array([[1], [4], [6], [4], [1]], dtype=np.int32)
BLUR_SEP5_SHIFT = 4  # /16


def mask_float(int_mask: np.ndarray, shift: int) -> np.ndarray:
    """Float32 view of an integer mask (exact: weights are binary fractions)."""
    return (int_mask.astype(np.float32)) / np.float32(1 << shift)


# ---------------------------------------------------------------------------
# Border handling
# ---------------------------------------------------------------------------

def mirror_index(i: np.ndarray | int, n: int):
    """SYCL-parity mirror: i<0 -> -i ; i>=n -> 2n-i-1 ; else i.

    Valid for offsets up to n-1 out of range (always true here: |offset| <= 2,
    n >= 3). [reference: benchmarks/sycl/benchmark.cpp:143-146]
    """
    i = np.asarray(i)
    i = np.where(i < 0, -i, i)
    i = np.where(i >= n, 2 * n - i - 1, i)
    return i


# ---------------------------------------------------------------------------
# The operation matrix: (display name, output file prefix, CSV column)
# [reference: benchmarks/opencv/benchmark.py:92-105, assets/results.csv:1]
# ---------------------------------------------------------------------------

OPERATION_MATRIX = (
    ("Upload", "", "Upload"),
    ("Download", "", "Download"),
    ("Copy", "copy", "Copy"),
    ("Inversion", "inversion", "Inversion"),
    ("Grayscale", "grayscale", "Grayscale"),
    ("Threshold", "threshold", "Threshold"),
    ("Erosion (3x3 Cross Kernel)", "erosion-cross", "Erosion-3x3-Cross"),
    ("Erosion (3x3 Square Kernel)", "erosion-square", "Erosion-3x3-Square"),
    ("Erosion (1x3+3x1 Square Kernel)", "erosion-square-separated",
     "Erosion-1x3+3x1-Square"),
    ("Convolution (3x3 Gaussian Blur Kernel)", "convolution-gaussian-blur-3x3",
     "Convolution-3x3"),
    ("Convolution (1x3+3x1 Gaussian Blur Kernel)",
     "convolution-gaussian-blur-3x3-separated", "Convolution-1x3+3x1"),
    ("Convolution (5x5 Gaussian Blur Kernel)", "convolution-gaussian-blur-5x5",
     "Convolution-5x5"),
    ("Convolution (1x5+5x1 Gaussian Blur Kernel)",
     "convolution-gaussian-blur-5x5-separated", "Convolution-1x5+5x1"),
    ("Gaussian Blur (3x3 Kernel)", "gaussian-blur-3x3", "Gaussian-Blur-3x3"),
)

CSV_COLUMNS = tuple(col for _, _, col in OPERATION_MATRIX)
CSV_HEADER = "Tool," + ",".join(CSV_COLUMNS)
