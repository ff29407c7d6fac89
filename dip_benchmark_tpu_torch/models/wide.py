"""Row-block streaming: one op applied to an image of any height.

The port of ``dip_benchmark_tpu/models/wide.py``'s ``apply_streaming``
(with its ``WINDOWED_COLS`` and ``WIDE_COLS``). An image whose planar does
not fit on the card (a 100,000 x 80,000 whole-slide scan is 96 GB as a
float32 planar, 24 GB in uint8) is cut into blocks of ``block_rows`` rows.
Each block is baked on the host from the whole image
(``utils.image.to_planar_padded(image, layout, row0)``: true neighbour rows
at an interior block edge, the spec's mirror at the image's top and
bottom), copied to the card once, run through the op's kernel (``OPS`` or
``OPS_F32``, the launches of the whole-image op, once a block), and its
valid rows are cropped and stitched on the host. So the result is the
whole-image op's, bit for bit.

What is not ported: the JAX module's column strips (``make_wide_layout``,
the strip refresh, ``WideBenchmarkSession``). They exist because the TPU's
windowed kernels have a width envelope; the port's kernels put the columns
on the grid, so a block is one buffer of the single-buffer layout at any
width. Hence no ``strip_width`` argument. ``device`` is explicit: the JAX
function runs on JAX's default device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import spec
from ..ops import OPS, OPS_F32
from ..runtime import gate_backend
from ..utils.image import (DEFAULT_HALO, check_uint8_hwc, crop_planar,
                           from_planar_padded, make_layout, to_planar_padded,
                           to_planar_padded_f32)

#: Ops that read neighbour pixels.
WINDOWED_COLS = frozenset((
    "Erosion-3x3-Cross", "Erosion-3x3-Square", "Erosion-1x3+3x1-Square",
    "Convolution-3x3", "Convolution-1x3+3x1", "Convolution-5x5",
    "Convolution-1x5+5x1", "Gaussian-Blur-3x3", "Fused-Pipeline"))

#: The device ops that stream (the memory rows move data, they are no op).
WIDE_COLS = tuple(dict.fromkeys(
    ("Copy", "Inversion", "Grayscale", "Threshold")
    + tuple(c for c in spec.CSV_COLUMNS if c in WINDOWED_COLS)
    + ("Fused-Pipeline",)))


def block_starts(height: int, block_rows: int) -> tuple[int, list[int]]:
    """The JAX package's cut: ``block_rows`` clamped to the height and
    raised to the halo's mirror minimum (halo + 1 rows), then the first row
    of each block, a remainder shorter than halo + 1 rows folded into the
    block before it. Returns the clamped ``block_rows`` and the starts."""
    block_rows = min(block_rows, height)
    block_rows = max(block_rows, min(height, DEFAULT_HALO + 1))
    starts = list(range(0, height, block_rows))
    if len(starts) > 1 and height - starts[-1] < DEFAULT_HALO + 1:
        starts.pop()
    return block_rows, starts


def apply_streaming(image: np.ndarray, col: str, block_rows: int = 2048,
                    dtype: str = "uint8",
                    device: torch.device | None = None) -> np.ndarray:
    """One application of op ``col`` to the uint8 HWC ``image``, in row
    blocks of ``block_rows`` on ``device`` (default: the current CUDA
    device; ``DeviceGateError`` without one, never the CPU unasked).

    dtype "uint8": uint8 HWC out. "float32": the float32 data model,
    ``(C, H, W)`` float32 in [0, 1] out, cropped without quantising.
    Composing calls stays exact, each pass being the whole-image op, at a
    host round trip a pass."""
    if col not in WIDE_COLS:
        raise ValueError(f"unknown column {col!r}; valid: {WIDE_COLS}")
    if dtype not in ("uint8", "float32"):
        raise ValueError(f"Unknown dtype: {dtype!r}")
    check_uint8_hwc(image)
    device = gate_backend("cuda") if device is None else torch.device(device)
    f32 = dtype == "float32"
    op = (OPS_F32 if f32 else OPS)[col]
    bake = to_planar_padded_f32 if f32 else to_planar_padded
    h, w, c = image.shape
    block_rows, starts = block_starts(h, block_rows)
    result = (np.empty((c, h, w), np.float32) if f32
              else np.empty_like(image))
    for i, y0 in enumerate(starts):
        hb = h - y0 if i == len(starts) - 1 else block_rows
        layout = make_layout(hb, w, c)
        out = op(bake(image, layout, y0).to(device))
        if f32:
            result[:, y0:y0 + hb] = crop_planar(out, layout)
        else:
            result[y0:y0 + hb] = from_planar_padded(out, layout)
    return result
