"""The library path over a mesh: the 12 ops of the matrix and the fused
pipeline, row-sharded, in plain PyTorch calls.

The port of ``dip_benchmark_tpu/parallel/ops.py`` (its "xla" path). A
shard is a planar ``(C, h_loc, W)`` block of valid rows on its device
(``parallel/halo.py``). A windowed op gets its halo rows from the
neighbouring shards (``exchange_row_halo``, the spec's mirror rule on the
edge shards) and mirror-pads its columns locally, since columns are never
sharded; so every op equals the unsharded one. A separable op exchanges
its intermediate's halo again between the passes, which reproduces the
reference's re-mirrored intermediate.

The local bodies are the JAX package's: a min over shifted slices, an
int32 multiply-add with ``(acc + half) >> shift`` and a clamp (uint8),
and in float32 the sum of the column sums in the JAX order
(``_conv_local_f32``), not ``F.conv2d``'s; the float32 point ops are
``ops/library_f32.py``'s.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import spec
from ..ops import library_f32
from .halo import Mesh, exchange_row_halo, sharded_op


def _mirror_cols(x: torch.Tensor, px: int) -> torch.Tensor:
    # The library path's column mirror, dtype-agnostic, no row padding.
    return library_f32.mirror_pad_chw(x, 0, px)


def _erode_local(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """Min over ``kh x kw``: the rows of ``x`` include ``kh // 2`` halo
    rows a side, the columns are mirror-padded here; returns the valid
    rows. A min of ``kw`` column slices, then of ``kh`` row slices."""
    padded = _mirror_cols(x, kw // 2)
    h, w = x.shape[-2] - (kh - 1), x.shape[-1]
    rows = padded[..., 0:w]
    for kx in range(1, kw):
        rows = torch.minimum(rows, padded[..., kx:kx + w])
    acc = rows[..., 0:h, :]
    for ky in range(1, kh):
        acc = torch.minimum(acc, rows[..., ky:ky + h, :])
    return acc


def _conv_local(x: torch.Tensor, int_mask: np.ndarray,
                shift: int) -> torch.Tensor:
    """Integer-exact correlation, rounded half up and clamped to uint8;
    the halo contract of ``_erode_local``."""
    kh, kw = int_mask.shape
    padded = _mirror_cols(x, kw // 2).to(torch.int32)
    h, w = x.shape[-2] - (kh - 1), x.shape[-1]
    acc = 0
    for ky in range(kh):
        for kx in range(kw):
            acc = acc + int(int_mask[ky, kx]) * padded[..., ky:ky + h,
                                                       kx:kx + w]
    half = 1 << (shift - 1)
    return torch.clamp((acc + half) >> shift, 0, 255).to(torch.uint8)


def _point_bodies() -> dict:
    """The uint8 point ops on a planar ``(C, H, W)`` block."""
    def grayscale(x):
        r, g, b = x.to(torch.int32)
        nr, ng, nb = spec.GRAYSCALE_WEIGHTS_INT_RGB
        gray = ((nr * r + ng * g + nb * b) >> spec.GRAYSCALE_SHIFT).to(
            torch.uint8)
        return gray.expand_as(x).contiguous()

    def threshold(x):
        return torch.where(x > spec.THRESHOLD_VALUE, spec.THRESHOLD_MAX,
                           0).to(torch.uint8)

    return {"Copy": torch.clone, "Inversion": lambda x: 255 - x,
            "Grayscale": grayscale, "Threshold": threshold}


def _conv_local_f32(x: torch.Tensor, int_mask: np.ndarray,
                    shift: int) -> torch.Tensor:
    """float32 correlation in the JAX package's order: for each mask
    column, the sum over its rows; then the sum of those column sums.
    Float sums do not reassociate, so the order is part of the contract."""
    fmask = spec.mask_float(int_mask, shift)
    kh, kw = fmask.shape
    padded = _mirror_cols(x, kw // 2)
    h, w = x.shape[-2] - (kh - 1), x.shape[-1]
    acc = None
    for kx in range(kw):
        col = None
        for ky in range(kh):
            term = padded[..., ky:ky + h, kx:kx + w] * float(fmask[ky, kx])
            col = term if col is None else col + term
        acc = col if acc is None else acc + col
    return acc


def _build(mesh: Mesh, points: dict, conv) -> dict:
    """The 13 sharded ops of one data model: its ``points`` and its
    correlation ``conv(x, int_mask, shift)``; the min is dtype-free."""

    def lift(body):
        # A body of a block that needs no halo rows.
        return lambda blocks: tuple(body(x) for x in blocks)

    def exchanged(aux, halo):
        # A sharded intermediate's shards, each extended by ``halo`` rows.
        return [x for row in mesh.rows(aux)
                for x in exchange_row_halo(row, halo)]

    def erosion_cross(xp):  # one halo row a side
        row = _erode_local(xp[..., 1:-1, :], 1, 3)  # 1x3: no row halo
        return torch.minimum(row, _erode_local(xp, 3, 1))

    def erosion_sep(blocks):
        aux = [_erode_local(x, 1, 3) for x in blocks]
        return tuple(_erode_local(x, 3, 1) for x in exchanged(aux, 1))

    def conv_sep(row_mask, col_mask, shift):
        def op(blocks):
            aux = [conv(x, row_mask, shift) for x in blocks]  # no row halo
            return tuple(conv(x, col_mask, shift)
                         for x in exchanged(aux, col_mask.shape[0] // 2))
        return op

    def pipeline(blocks):
        t = [points["Threshold"](points["Grayscale"](x)) for x in blocks]
        e = [_erode_local(x, 3, 3) for x in exchanged(t, 1)]
        return tuple(conv(x, spec.BLUR_3X3_INT, spec.BLUR_3X3_SHIFT)
                     for x in exchanged(e, 1))

    def blur(xp):
        return conv(xp, spec.BLUR_3X3_INT, spec.BLUR_3X3_SHIFT)

    ops = {col: lift(body) for col, body in points.items()}
    ops.update({
        "Erosion-3x3-Cross": sharded_op(erosion_cross, mesh, 1),
        "Erosion-3x3-Square": sharded_op(
            lambda xp: _erode_local(xp, 3, 3), mesh, 1),
        "Erosion-1x3+3x1-Square": erosion_sep,
        "Convolution-3x3": sharded_op(blur, mesh, 1),
        "Convolution-1x3+3x1": conv_sep(spec.BLUR_1X3_INT, spec.BLUR_3X1_INT,
                                        spec.BLUR_SEP3_SHIFT),
        "Convolution-5x5": sharded_op(
            lambda xp: conv(xp, spec.BLUR_5X5_INT, spec.BLUR_5X5_SHIFT),
            mesh, 2),
        "Convolution-1x5+5x1": conv_sep(spec.BLUR_1X5_INT, spec.BLUR_5X1_INT,
                                        spec.BLUR_SEP5_SHIFT),
        "Gaussian-Blur-3x3": sharded_op(blur, mesh, 1),
        "Fused-Pipeline": pipeline,
    })
    return ops


def build_sharded_ops(mesh: Mesh) -> dict:
    """CSV column -> op of a sharded uint8 value of ``(C, h_loc, W)``
    blocks, returning one of the same shape."""
    return _build(mesh, _point_bodies(), _conv_local)


def build_sharded_ops_f32(mesh: Mesh) -> dict:
    """The float32 model's ops (``(3, h_loc, W)`` blocks in [0, 1]): the
    point ops of ``ops/library_f32.py``, the min as in uint8, and the
    correlations in the JAX order (``_conv_local_f32``)."""
    points = {col: library_f32.IMAGE_OPS_F32[col]
              for col in ("Copy", "Inversion", "Grayscale", "Threshold")}
    return _build(mesh, points, _conv_local_f32)
