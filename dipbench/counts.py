"""Logical bytes and operations of one application of each op, and the
peaks they are held to.

The bytes are those of the logical image: each of its H x W x 3 elements
read once and written once, whatever layout, padding or halo reads an
implementation adds, so the yardstick does not move when the layout
does. The operations are the arithmetic the op's definition needs an
output element (a multiply and an add count two, a compare or a min
one); the luma's five operations are made once a pixel and shared by its
three planes.
"""

from __future__ import annotations

# One NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W): HBM3
# bytes/s and FP32 operations/s outside the tensor cores.
PEAKS = {"hbm_bytes_s": 3.35e12, "fp32_ops_s": 67e12}

ITEMSIZE = {"uint8": 1, "float32": 4}

# Operations an output element, per column of the matrix.
OPS_PER_ELEMENT = {
    "Copy": 0,
    "Inversion": 1,
    "Grayscale": 5 / 3,
    "Threshold": 1,
    "Erosion-3x3-Cross": 4,
    "Erosion-3x3-Square": 8,
    "Erosion-1x3+3x1-Square": 4,
    "Convolution-3x3": 17,
    "Convolution-1x3+3x1": 10,
    "Convolution-5x5": 49,
    "Convolution-1x5+5x1": 18,
    "Gaussian-Blur-3x3": 10,
    # luma 5 and threshold 1 a pixel, the 3x3 min 8 and the blur 10 on
    # one plane, for three output planes
    "Fused-Pipeline": (5 + 1 + 8 + 10) / 3,
}


def elements(height: int, width: int, channels: int = 3) -> int:
    return height * width * channels


def op_bytes(height: int, width: int, dtype: str) -> int:
    """Bytes one application moves: the image read once, written once."""
    return 2 * elements(height, width) * ITEMSIZE[dtype]


def op_operations(col: str, height: int, width: int) -> float:
    return OPS_PER_ELEMENT[col] * elements(height, width)


def bound_s(col: str, height: int, width: int, dtype: str) -> float:
    """The least time one application can take on the card: the larger
    of its bytes at the HBM rate and its operations at the FP32 rate."""
    return max(op_bytes(height, width, dtype) / PEAKS["hbm_bytes_s"],
               op_operations(col, height, width) / PEAKS["fp32_ops_s"])
