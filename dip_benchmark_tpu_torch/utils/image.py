"""Image I/O and the port's device layout: a planar, mirror-padded image.

Image I/O and the input check are the port's own copies of
``dip_benchmark_tpu/utils/image.py``'s: RGB uint8 HWC at the edges, cv2
first (it matches the reference's JPEG decode) and PIL as the fallback.

The layout keeps the reference's contract: planar ``(C, Hp, pitch)``
uint8 with the spec's mirror border baked into ``pad`` halo rows and
columns, so windowed kernels read every tap without a boundary branch and
every op maps the layout to itself. What changes is the geometry: the
TPU's 128-lane width, 8-row DMA tiles and VMEM bands are gone. Rows are
exactly ``H + 2 * pad``; the pitch is ``W + 2 * pad`` rounded up to 16
elements so 16-byte vector loads cover every row and plane.

The bakes here run on the host, in NumPy, one gather for every caller:
the session's image at set-up, the sharded and streamed blocks, and the
tests' reference stack. The batch tool uploads its stacks as they are and
bakes them where they are (``ops/layout.bake_stack``: the ``bake_u8``
kernel on the card, its plain version on the CPU), to the same bytes.

The float32 data model keeps the same geometry: ``(C, Hp, pitch)``
float32 in [0, 1], the uint8 bake divided by 255 on the host
(``to_planar_padded_f32``), and a crop that quantizes after cropping
(``from_planar_padded_f32``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from .. import spec

try:  # cv2 matches the reference's JPEG decode exactly (opencv/benchmark.py:14)
    import cv2 as _cv2
except ImportError:  # pragma: no cover
    _cv2 = None

DEFAULT_HALO = 2   # the largest kernel radius of the op matrix (5x5)
PITCH_ALIGN = 16   # elements: one uint4 vector of uint8, four of float32


# -- image I/O -------------------------------------------------------------

def load_image(path: str) -> np.ndarray:
    """Load an image file as uint8 RGB HWC."""
    if _cv2 is not None:
        bgr = _cv2.imread(path, _cv2.IMREAD_COLOR)
        if bgr is None:
            raise ValueError(f"Not a valid image file: {path}")
        return np.ascontiguousarray(bgr[..., ::-1])
    from PIL import Image  # pragma: no cover
    return np.asarray(Image.open(path).convert("RGB"))  # pragma: no cover


def save_image(path: str, image: np.ndarray) -> None:
    """Save a uint8 RGB HWC image."""
    check_uint8_hwc(image)
    if _cv2 is not None:
        ok = _cv2.imwrite(path, np.ascontiguousarray(image[..., ::-1]))
        if not ok:
            raise IOError(f"Failed to write {path}")
        return
    from PIL import Image  # pragma: no cover
    Image.fromarray(image).save(path)  # pragma: no cover


def check_uint8_hwc(image: np.ndarray) -> None:
    """Input contract of the session and the batch tool, as a ValueError
    (not assert: python -O strips asserts)."""
    if (getattr(image, "dtype", None) != np.uint8
            or getattr(image, "ndim", 0) != 3
            or image.shape[2] != 3):
        raise ValueError(
            f"expected a uint8 HWC RGB image array (3 channels), got "
            f"dtype={getattr(image, 'dtype', type(image))} "
            f"shape={getattr(image, 'shape', '?')}")


def is_image_file(path: str) -> bool:
    if not os.path.isfile(path):
        return False
    if _cv2 is not None:
        return _cv2.haveImageReader(path)
    try:  # pragma: no cover
        from PIL import Image
        with Image.open(path) as im:
            im.verify()
        return True
    except (OSError, SyntaxError):
        return False


# -- planar layout ---------------------------------------------------------


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


def mirror_rows(layout: PlanarLayout, row0: int = 0,
                height: int | None = None) -> np.ndarray:
    """Source image row of every padded row. With ``row0`` and the full
    image's ``height`` the layout is a row block of that image from row
    ``row0`` on: its pad rows are the image's true neighbour rows inside
    it and the spec's mirror past its edges (the JAX package's
    ``models/wide.to_wide_resident`` rule)."""
    h = layout.height if height is None else height
    return np.clip(spec.mirror_index(
        row0 + np.arange(layout.padded_height) - layout.pad, h), 0, h - 1)


def mirror_cols(layout: PlanarLayout) -> np.ndarray:
    """Source image column of every padded column, slack included (the
    clamped mirror rule of the JAX package's ``mirror_col_index``)."""
    return np.clip(spec.mirror_index(
        np.arange(layout.pitch) - layout.pad, layout.width),
        0, layout.width - 1)


def _mirror_gather(planar: np.ndarray, layout: PlanarLayout,
                   row0: int = 0) -> torch.Tensor:
    """``(..., C, H, W)`` -> the contiguous ``(..., C, Hp, pitch)`` CPU
    tensor of ``layout`` over the rows ``[row0, row0 + layout.height)``:
    rows by ``mirror_rows`` of the whole ``H``, every column by
    ``mirror_cols``. Leading dims (a batch) and the dtype pass through."""
    c, h, w = planar.shape[-3:]
    if ((c, w) != (layout.channels, layout.width) or row0 < 0
            or row0 + layout.height > h):
        raise ValueError(f"planar {planar.shape} from row {row0} does not "
                         f"fit {layout}")
    ys, xs = mirror_rows(layout, row0, h), mirror_cols(layout)
    return torch.from_numpy(np.ascontiguousarray(
        planar[..., ys[:, None], xs[None, :]]))


def _valid_region(planar, layout: PlanarLayout):
    """The ``(..., H, W)`` view of a planar buffer's or stack's image."""
    p = layout.pad
    return planar[..., p:p + layout.height, p:p + layout.width]


def to_planar_padded(image: np.ndarray, layout: PlanarLayout,
                     row0: int = 0) -> torch.Tensor:
    """HWC uint8 -> ``(C, Hp, pitch)`` uint8 CPU tensor, mirror halo baked.

    ``row0``: ``layout`` covers the rows ``[row0, row0 + layout.height)``
    of ``image`` (a row block of ``models/wide.apply_streaming``), whose
    pad rows come from the whole image (``mirror_rows``); the default
    bakes the whole image."""
    return _mirror_gather(np.transpose(image, (2, 0, 1)), layout, row0)


def stack_planar_padded(images: np.ndarray,
                        layout: PlanarLayout) -> torch.Tensor:
    """``(B, H, W, C)`` uint8 -> ``(B, C, Hp, pitch)`` uint8 CPU tensor,
    each image baked as ``to_planar_padded`` bakes it."""
    return _mirror_gather(np.transpose(images, (0, 3, 1, 2)), layout)


def crop_planar(planar: torch.Tensor, layout: PlanarLayout) -> np.ndarray:
    """``(C, Hp, pitch)`` on any device -> the ``(C, H, W)`` host array of
    its valid region, its dtype kept (the float32 model's native output,
    unquantised)."""
    return _valid_region(planar, layout).cpu().numpy()


def from_planar_padded(planar: torch.Tensor,
                       layout: PlanarLayout) -> np.ndarray:
    """``(C, Hp, pitch)`` or ``(B, C, Hp, pitch)`` on any device -> HWC or
    ``(B, H, W, C)`` host array of its dtype, cropped."""
    valid = _valid_region(planar, layout)
    return valid.movedim(-3, -1).contiguous().cpu().numpy()


def to_planar_padded_f32(image: np.ndarray, layout: PlanarLayout,
                         row0: int = 0) -> torch.Tensor:
    """HWC uint8 -> ``(C, Hp, pitch)`` float32 CPU tensor in [0, 1], the
    uint8 bake divided by 255 in NumPy (exact per element: u8 / 255
    commutes with the mirror gather). The division stays on the host: a
    division on the card need not round as NumPy's does. ``row0`` as in
    ``to_planar_padded``."""
    baked = to_planar_padded(image, layout, row0).numpy()
    return torch.from_numpy(baked.astype(np.float32) / np.float32(255))


def from_planar_padded_f32(planar: torch.Tensor,
                           layout: PlanarLayout) -> np.ndarray:
    """``(C, Hp, pitch)`` or ``(B, C, Hp, pitch)`` float32 on any device ->
    HWC or ``(B, H, W, C)`` uint8 host array: crop first, then
    ``clip(rint(x * 255), 0, 255)``, as the JAX package's f32 crop does."""
    x = from_planar_padded(planar, layout)
    return np.clip(np.rint(x * np.float32(255)), 0, 255).astype(np.uint8)


def from_jax_planar(arr: np.ndarray, jax_layout,
                    pad: int = DEFAULT_HALO) -> torch.Tensor:
    """Re-cut the JAX package's planar array into the port's layout
    ``make_layout(h, w, c, pad=pad)``.

    ``arr`` is a ``(C, Hp, Wp)`` array from
    ``dip_benchmark_tpu.utils.image.to_planar_padded`` or
    ``to_planar_padded_f32`` (or a JAX op's output) on ``jax_layout``, or
    a ``(B, C, Hp, Wp)`` stack of them; its dtype is kept. Both layouts
    bake the same mirror and slack rules relative to the image origin, so
    the port's buffer is the window of ``pad`` rows and columns around the
    image, ``pitch`` columns wide; ``pad`` may be at most the JAX layout's
    halo (a chain of radius R needs a JAX bake with ``halo=R``). A JAX f32
    layout (``make_layout(..., itemsize=4)``) has another band and so
    another height; the window is cut the same way.
    """
    layout = make_layout(jax_layout.height, jax_layout.width,
                         jax_layout.channels, pad)
    y0 = jax_layout.pad_y - layout.pad
    x0 = jax_layout.pad_x - layout.pad
    if arr.ndim not in (3, 4):
        raise ValueError(f"expected a (C, Hp, Wp) or (B, C, Hp, Wp) array, "
                         f"got shape {arr.shape}")
    c, hp, wp = arr.shape[-3:]
    if (c != layout.channels or y0 < 0 or x0 < 0
            or y0 + layout.padded_height > hp or x0 + layout.pitch > wp):
        raise ValueError(
            f"JAX planar {arr.shape} on {jax_layout} cannot hold the "
            f"port's {layout.shape} window")
    return torch.from_numpy(np.ascontiguousarray(
        arr[..., y0:y0 + layout.padded_height, x0:x0 + layout.pitch]))


# -- the resident sharded layout -------------------------------------------

def to_resident_planar(planar: np.ndarray, layout: PlanarLayout,
                       n: int) -> tuple[torch.Tensor, ...]:
    """``(..., C, H, W)`` -> n CPU tensors ``(..., C, Hp, pitch)``: the
    resident sharded layout of ``parallel/``, one block per row shard.

    Shard i holds rows ``[i * h_loc, (i + 1) * h_loc)`` (``h_loc = H / n``,
    ``layout`` the per-shard layout); its block is the port's bake of those
    rows: ``pad`` rows above and below from the neighbouring shards, or by
    the spec's mirror rule past the image's edges, and every column as
    ``mirror_cols`` fills it. Each block is contiguous, so the kernels run
    on it as they run on an unsharded planar. Leading dims (a batch) and
    the dtype pass through; n = 1 gives ``to_planar_padded``'s buffer."""
    h, w = planar.shape[-2:]
    if h % n:
        raise ValueError(f"{n} shards must divide height {h}")
    h_loc = h // n
    if (layout.height, layout.width) != (h_loc, w):
        raise ValueError(f"{layout} is not the per-shard layout of {n} "
                         f"shards of {h}x{w}")
    return tuple(_mirror_gather(planar, layout, i * h_loc) for i in range(n))


def from_resident_planar(blocks, layout: PlanarLayout, h_loc: int,
                         height: int | None = None) -> np.ndarray:
    """The blocks of ``to_resident_planar`` (or of an op's output), on any
    device -> the ``(..., height, W)`` host array of their valid rows and
    columns, shard after shard; ``height`` crops a session's row padding
    (default: all ``len(blocks) * h_loc`` rows)."""
    if h_loc != layout.height:
        # h_loc is redundant with the layout; a mismatch would silently
        # return wrongly cropped rows.
        raise ValueError(f"h_loc {h_loc} != layout.height {layout.height}")
    valid = np.concatenate([_valid_region(b, layout).cpu().numpy()
                            for b in blocks], axis=-2)
    return np.ascontiguousarray(valid[..., :height, :])


def from_jax_resident(arr: np.ndarray, jax_layout, n: int,
                      pad: int = DEFAULT_HALO) -> tuple[torch.Tensor, ...]:
    """Re-cut the JAX package's resident array into the port's blocks.

    ``arr`` is a ``(..., C, n * Hp, Wp)`` array from
    ``dip_benchmark_tpu.utils.image.to_resident_planar`` (or a sharded op's
    output) on the per-shard ``jax_layout``: n padded blocks stacked along
    the rows. Both packages bake a block by the same rules relative to the
    shard's first row, so each port block is ``from_jax_planar`` of the
    JAX block."""
    hp = jax_layout.padded_height
    if arr.shape[-2] != n * hp:
        raise ValueError(f"JAX resident {arr.shape} is not {n} blocks of "
                         f"{hp} rows")
    return tuple(from_jax_planar(arr[..., i * hp:(i + 1) * hp, :],
                                 jax_layout, pad) for i in range(n))
