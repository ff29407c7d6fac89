"""The port's device layout: a planar, mirror-padded uint8 image.

Image I/O and the input check stay in ``dip_benchmark_tpu.utils.image``,
which is NumPy-only; this module re-exports them, so the rest of the port
and its users take them from here.

The layout keeps the reference's contract: planar ``(C, Hp, pitch)``
uint8 with the spec's mirror border baked into ``pad`` halo rows and
columns, so windowed kernels read every tap without a boundary branch and
every op maps the layout to itself. What changes is the geometry: the
TPU's 128-lane width, 8-row DMA tiles and VMEM bands are gone. Rows are
exactly ``H + 2 * pad``; the pitch is ``W + 2 * pad`` rounded up to 16
bytes so 16-byte vector loads cover every row and plane.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dip_benchmark_tpu import spec
from dip_benchmark_tpu.utils.image import (  # noqa: F401
    check_uint8_hwc, is_image_file, load_image, save_image)

DEFAULT_HALO = 2   # the largest kernel radius of the op matrix (5x5)
PITCH_ALIGN = 16   # bytes: one uint4 vector


@dataclass(frozen=True)
class PlanarLayout:
    """Geometry of the planar padded layout, shape ``(C, Hp, pitch)``.

    Rows ``[pad, pad + height)`` and columns ``[pad, pad + width)`` hold the
    image; ``pad`` mirror rows and columns surround it (``spec.mirror_index``)
    and columns past ``width + 2 * pad`` are alignment slack, filled by the
    same clamped mirror rule as the JAX layout's lane padding.
    """
    height: int
    width: int
    channels: int = 3
    pad: int = DEFAULT_HALO

    @property
    def padded_height(self) -> int:
        return self.height + 2 * self.pad

    @property
    def pitch(self) -> int:
        w = self.width + 2 * self.pad
        return -(-w // PITCH_ALIGN) * PITCH_ALIGN

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.channels, self.padded_height, self.pitch)


def make_layout(height: int, width: int, channels: int = 3,
                pad: int = DEFAULT_HALO) -> PlanarLayout:
    if min(height, width) < pad + 1:
        # spec.mirror_index reflects offsets up to n - 1 only.
        raise ValueError(
            f"a {pad}-pixel mirror halo needs an image of at least "
            f"{pad + 1}x{pad + 1}, got {height}x{width}")
    return PlanarLayout(height, width, channels, pad)


def mirror_rows(layout: PlanarLayout) -> np.ndarray:
    """Source image row of every padded row."""
    return np.clip(spec.mirror_index(
        np.arange(layout.padded_height) - layout.pad, layout.height),
        0, layout.height - 1)


def mirror_cols(layout: PlanarLayout) -> np.ndarray:
    """Source image column of every padded column, slack included (the
    rule of ``dip_benchmark_tpu.utils.image.mirror_col_index``)."""
    return np.clip(spec.mirror_index(
        np.arange(layout.pitch) - layout.pad, layout.width),
        0, layout.width - 1)


def to_planar_padded(image: np.ndarray, layout: PlanarLayout) -> torch.Tensor:
    """HWC uint8 -> ``(C, Hp, pitch)`` uint8 CPU tensor, mirror halo baked."""
    if image.shape != (layout.height, layout.width, layout.channels):
        raise ValueError(f"image {image.shape} does not fit {layout}")
    planar = np.transpose(image, (2, 0, 1))
    ys, xs = mirror_rows(layout), mirror_cols(layout)
    return torch.from_numpy(
        np.ascontiguousarray(planar[:, ys[:, None], xs[None, :]]))


def from_planar_padded(planar: torch.Tensor,
                       layout: PlanarLayout) -> np.ndarray:
    """``(C, Hp, pitch)`` on any device -> HWC uint8 host array, cropped."""
    p = layout.pad
    valid = planar[:, p:p + layout.height, p:p + layout.width]
    return valid.permute(1, 2, 0).contiguous().cpu().numpy()


def from_jax_planar(arr: np.ndarray, jax_layout) -> torch.Tensor:
    """Re-cut the JAX package's planar array into the port's layout.

    ``arr`` is a ``(C, Hp, Wp)`` array from
    ``dip_benchmark_tpu.utils.image.to_planar_padded`` (or a JAX op's
    output) on ``jax_layout``. Both layouts bake the same mirror and slack
    rules relative to the image origin, so the port's buffer is the window
    of ``pad`` rows and columns around the image, ``pitch`` columns wide.
    """
    layout = make_layout(jax_layout.height, jax_layout.width,
                         jax_layout.channels)
    y0 = jax_layout.pad_y - layout.pad
    x0 = jax_layout.pad_x - layout.pad
    c, hp, wp = arr.shape
    if (c != layout.channels or y0 < 0 or x0 < 0
            or y0 + layout.padded_height > hp or x0 + layout.pitch > wp):
        raise ValueError(
            f"JAX planar {arr.shape} on {jax_layout} cannot hold the "
            f"port's {layout.shape} window")
    return torch.from_numpy(np.ascontiguousarray(
        arr[:, y0:y0 + layout.padded_height, x0:x0 + layout.pitch]))
