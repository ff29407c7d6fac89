"""Row sharding on one controller: a mesh of devices, shards as tensors on
them, and the halo exchange between neighbouring shards.

The port of ``dip_benchmark_tpu/parallel/halo.py``. The JAX package shards
an image's rows over a mesh of devices with ``shard_map`` and moves halo
rows between neighbours with ``lax.ppermute``; one process drives every
device. The port keeps that single-controller model: a ``Mesh`` is a grid
of ``torch.device``s, a shard is a tensor on its device, and the exchange
is strip copies between shard tensors (``copy_`` across devices where two
shards sit on different ones). The global mirror rule applies only on the
edge shards, so a sharded windowed op equals the unsharded one.

A sharded value is a tuple of blocks in mesh order: ``blocks[d * n_space
+ s]`` is the shard of batch part d and row band s, on ``mesh.devices[d]
[s]``. On the library path a block holds its valid rows only, ``(C,
h_loc, W)``; on the kernel path (``parallel/kernel_ops.py``) it is its
full padded layout, ``(C, Hp, pitch)``, whose halos
``refresh_resident_halo`` and ``refresh_resident_cols`` renew in place.

Deviation from the JAX mesh, which needs a device per shard: ``make_mesh``
deals the shards round-robin over the visible CUDA devices, so several
shards may share one card. That is what lets one card run n > 1.
"""

from __future__ import annotations

import functools
import sys
from dataclasses import dataclass

import numpy as np
import torch

from ..runtime import DeviceGateError, synchronize
from ..utils.image import PlanarLayout, mirror_cols


@dataclass(frozen=True)
class Mesh:
    """``n_data x n_space`` devices: ``devices[d][s]`` holds the shard of
    batch part d and row band s."""
    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def n_space(self) -> int:
        return len(self.devices[0])

    @property
    def n_data(self) -> int:
        return len(self.devices)

    @property
    def flat(self) -> tuple[torch.device, ...]:
        """Every shard's device, in mesh order."""
        return tuple(d for row in self.devices for d in row)

    @property
    def distinct(self) -> tuple[torch.device, ...]:
        """The devices the mesh uses, each once."""
        return tuple(dict.fromkeys(self.flat))

    def rows(self, blocks) -> list[tuple]:
        """A sharded value's blocks, one tuple of ``n_space`` per batch
        part."""
        if len(blocks) != self.n_data * self.n_space:
            raise ValueError(f"{len(blocks)} blocks on a {self.n_data}x"
                             f"{self.n_space} mesh")
        s = self.n_space
        return [tuple(blocks[d * s:(d + 1) * s]) for d in range(self.n_data)]

    def synchronize(self) -> None:
        """Wait for the work queued on every device of the mesh."""
        for device in self.distinct:
            synchronize(device)


def make_mesh(n_space: int, n_data: int = 1, backend: str = "cuda") -> Mesh:
    """A ``(data, space)`` mesh of ``n_data x n_space`` shards. ``backend``
    "cpu" puts every shard on the CPU; "cuda" deals them round-robin over
    the visible CUDA devices (a NOTE on stderr names the placement when
    shards share a device) and never onto the CPU."""
    if n_space < 1 or n_data < 1:
        raise ValueError(f"a mesh needs n_space, n_data >= 1, got "
                         f"{n_space}, {n_data}")
    n = n_space * n_data
    if backend == "cpu":
        flat = [torch.device("cpu")] * n
    elif backend == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise DeviceGateError("No CUDA device available for a CUDA "
                                  "mesh; pass --backend cpu")
        flat = [torch.device("cuda", i % count) for i in range(n)]
        if count < n:
            print(f"NOTE: {n} shards on {count} CUDA device(s): shard i "
                  f"(mesh order) on cuda:(i mod {count})", file=sys.stderr)
    else:
        raise ValueError(f"unknown backend {backend!r} (want cuda|cpu)")
    return Mesh(tuple(tuple(flat[d * n_space:(d + 1) * n_space])
                      for d in range(n_data)))


def _mirror_rows_low(x: torch.Tensor, halo: int) -> torch.Tensor:
    # rows -halo..-1 are rows halo..1 (spec.mirror_index low: -i -> i)
    return x[..., 1:halo + 1, :].flip(-2)


def _mirror_rows_high(x: torch.Tensor, halo: int) -> torch.Tensor:
    # rows H..H+halo-1 are rows H-1..H-halo (high: 2n-i-1)
    return x[..., -halo:, :].flip(-2)


def exchange_row_halo(blocks, halo: int) -> list[torch.Tensor]:
    """One mesh row's ``(..., h_loc, W)`` shards, each extended to
    ``(..., h_loc + 2 * halo, W)`` on its device: the neighbours' edge
    rows, or the spec's mirror rule on the global edges."""
    n = len(blocks)
    out = []
    for i, x in enumerate(blocks):
        top = (_mirror_rows_low(x, halo) if i == 0
               else blocks[i - 1][..., -halo:, :].to(x.device))
        bot = (_mirror_rows_high(x, halo) if i == n - 1
               else blocks[i + 1][..., :halo, :].to(x.device))
        out.append(torch.cat([top, x, bot], dim=-2))
    return out


def refresh_resident_halo(blocks, pad: int, h_loc: int):
    """Renew the halo rows of one mesh row's resident blocks in place:
    rows ``[0, pad)`` of a block get the previous shard's last ``pad``
    valid rows, rows ``[pad + h_loc, h_loc + 2 * pad)`` the next shard's
    first ones, and the edge shards the spec's mirror of their own valid
    rows (valid rows at ``[pad, pad + h_loc)``). Only ``2 * pad`` rows a
    block move. Reads valid rows and writes halo rows only, so the order
    of the copies does not matter; needs ``h_loc >= pad + 1``."""
    n = len(blocks)
    for i, buf in enumerate(blocks):
        valid = buf[..., pad:pad + h_loc, :]
        top, bot = buf[..., :pad, :], buf[..., pad + h_loc:, :]
        top.copy_(_mirror_rows_low(valid, pad) if i == 0
                  else blocks[i - 1][..., h_loc:h_loc + pad, :])
        bot.copy_(_mirror_rows_high(valid, pad) if i == n - 1
                  else blocks[i + 1][..., pad:2 * pad, :])
    return blocks


@functools.lru_cache(maxsize=64)
def _col_index(pitch: int, pad: int, width: int,
               device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(source, destination) column indices of the column refresh on
    ``device``, made once: a copy to the card inside a captured CUDA graph
    would break the capture."""
    layout = PlanarLayout(1, width, 1, pad)
    if layout.pitch != pitch:
        raise ValueError(f"a block of pitch {pitch} is not a resident "
                         f"layout of width {width} and pad {pad}")
    xs = mirror_cols(layout)
    dst = np.concatenate([np.arange(pad), np.arange(pad + width, pitch)])
    return (torch.from_numpy(pad + xs[dst]).to(device),
            torch.from_numpy(dst).to(device))


def refresh_resident_cols(buf: torch.Tensor, pad: int,
                          width: int) -> torch.Tensor:
    """Re-mirror every column of a resident block outside its valid ones
    ``[pad, pad + width)``, in place and over the whole height: the
    ``pad`` halo columns each side and the pitch's slack, as
    ``utils.image.mirror_cols`` bakes them. Run after
    ``refresh_resident_halo``, it leaves the block equal to the port's
    bake of its rows (the corners included). Columns are never sharded, so
    this is local to the block; ``(..., Hp, pitch)``."""
    src, dst = _col_index(buf.shape[-1], pad, width, buf.device)
    return buf.index_copy_(-1, dst, buf.index_select(-1, src))


def sharded_op(local_fn, mesh: Mesh, halo: int):
    """Lift ``local_fn``, a function of a ``(..., h_loc + 2 * halo, W)``
    row-extended shard that returns its ``(..., h_loc, W)`` result, to a
    function of a sharded value (``exchange_row_halo`` within each mesh
    row, then ``local_fn`` on each shard)."""

    def op(blocks):
        return tuple(local_fn(x) for row in mesh.rows(blocks)
                     for x in exchange_row_halo(row, halo))
    return op


def _pipeline_local(xp: torch.Tensor) -> torch.Tensor:
    """The fused pipeline on one ``(C, h + 4, W)`` row-extended uint8
    shard in plain PyTorch: luma, threshold, the square erosion and the
    blur, each windowed stage consuming one halo row a side; columns by
    the global mirror rule, locally (they are never sharded)."""
    from .. import spec
    from .ops import _conv_local, _erode_local, _point_bodies

    pt = _point_bodies()
    eroded = _erode_local(pt["Threshold"](pt["Grayscale"](xp)), 3, 3)
    return _conv_local(eroded, spec.BLUR_3X3_INT, spec.BLUR_3X3_SHIFT)


def sharded_fused_pipeline(mesh: Mesh):
    """The fused pipeline over a ``(data, space)`` mesh in plain PyTorch:
    the batch split over the data axis, image rows over the space axis,
    a 2-row halo exchange. ``apply((B, C, H, W) uint8)`` returns the
    ``(B, C, H, W)`` result on the host; B must divide by ``n_data`` and H
    by ``n_space``."""
    op = sharded_op(lambda xp: torch.stack([_pipeline_local(im)
                                            for im in xp]), mesh, 2)

    def apply(batch) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(batch))
        b, _, h, _ = x.shape
        if b % mesh.n_data or h % mesh.n_space:
            raise ValueError(f"a ({b}, H={h}) batch does not divide over a "
                             f"{mesh.n_data}x{mesh.n_space} mesh")
        bl, hl = b // mesh.n_data, h // mesh.n_space
        blocks = tuple(
            x[d * bl:(d + 1) * bl, :, s * hl:(s + 1) * hl].contiguous().to(
                mesh.devices[d][s])
            for d in range(mesh.n_data) for s in range(mesh.n_space))
        return torch.cat([torch.cat([blk.cpu() for blk in row], dim=-2)
                          for row in mesh.rows(op(blocks))], dim=0)

    return apply
