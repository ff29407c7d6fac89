"""The hand-written kernels over a mesh, on the resident sharded model.

The port of ``dip_benchmark_tpu/parallel/pallas_ops.py``; the JAX package
calls this path "pallas", the port "kernel" (``--path kernel``). Each
shard's block is its full padded local layout, ``make_layout(h_loc, W,
pad=...)``, as its own contiguous ``(C, Hp, pitch)`` tensor (``(b_loc, C,
Hp, pitch)`` for a batch shard) on its device:

    block: [top halo (pad) | valid h_loc rows | bottom halo (pad)]

One application of a windowed op is three steps:
``halo.refresh_resident_halo`` (the halo rows from the neighbours' valid
edge rows, the spec's mirror on the edge shards), ``refresh_resident_cols``
(the halo columns and the pitch's slack re-mirrored), then the UNMODIFIED
kernel on each block. After the two refreshes every block equals the
port's bake of its rows, so the kernel cannot tell a neighbour's rows
from mirror rows and the sharded op equals the unsharded one bit for bit;
and since the kernels zero their outputs' outer ring, the refresh before
every windowed application is what lets sharded ops compose at any
depth. Point ops skip the refresh, as in the JAX package: the next
windowed op refreshes whatever they leave in the halos. The refresh is
PyTorch slicing and ``copy_``, as the JAX package computes it outside any
Pallas kernel; no kernel is added here.

Assemble blocks with ``utils.image.to_resident_planar``; read them back
with ``from_resident_planar``.
"""

from __future__ import annotations

from ..models import chain
from ..models.pipeline import fused_pipeline
from ..ops import OPS, OPS_F32
from ..utils.image import DEFAULT_HALO, PlanarLayout, make_layout
from .halo import Mesh, refresh_resident_cols, refresh_resident_halo

POINT_COLS = ("Copy", "Inversion", "Grayscale", "Threshold")


def _shard_layout(h_loc: int, width: int, halo: int | None = None,
                  what: str = "halo exchange") -> PlanarLayout:
    """The per-shard layout; ``halo`` overrides the op matrix's (a chain
    needs its total radius). The mirror rule of the edge shards needs at
    least ``pad + 1`` valid rows a shard."""
    pad = DEFAULT_HALO if halo is None else halo
    if h_loc < pad + 1:
        raise ValueError(
            f"shards of {h_loc} rows are too small for {what} "
            f"(need >= {pad + 1}); use fewer devices")
    return make_layout(h_loc, width, pad=pad)


def refresh(blocks, mesh: Mesh, layout: PlanarLayout):
    """Both refreshes of every block of a resident sharded value, in
    place: the rows within each mesh row, then each block's columns."""
    for row in mesh.rows(blocks):
        refresh_resident_halo(row, layout.pad, layout.height)
    for buf in blocks:
        refresh_resident_cols(buf, layout.pad, layout.width)
    return blocks


def _lift(op, mesh: Mesh, layout: PlanarLayout, windowed: bool):
    """``op`` of one block, as a function of a resident sharded value:
    the refresh first for a windowed op, then ``op`` on each block."""
    def apply(blocks):
        if windowed:
            refresh(blocks, mesh, layout)
        return tuple(op(buf) for buf in blocks)
    return apply


def _shard_height(mesh: Mesh, height: int) -> int:
    n = mesh.n_space
    if height % n:
        raise ValueError(f"the {n}-shard axis must divide height {height}")
    return height // n


def build_sharded_kernel_ops(mesh: Mesh, height: int, width: int,
                             dtype: str = "uint8") -> tuple[dict, PlanarLayout]:
    """CSV column -> op of a resident sharded value (``OPS`` or
    ``OPS_F32`` on each block, the CUDA kernel for a block on the card,
    its plain version on the CPU), and the per-shard layout. The mesh's
    space axis must divide ``height``."""
    if dtype not in ("uint8", "float32"):
        raise ValueError(f"Unknown dtype: {dtype!r}")
    layout = _shard_layout(_shard_height(mesh, height), width)
    local = OPS_F32 if dtype == "float32" else OPS
    return {col: _lift(op, mesh, layout, col not in POINT_COLS)
            for col, op in local.items()}, layout


def chain_row_padding(height: int, n: int, cols) -> int:
    """The mirror rows (high side) to add to ``height`` image rows before a
    chain runs on n row shards: enough that n divides the rows, that no
    pad falls short of the chain's halo ``max(2, ry, rx)`` (the bottom
    shard's mirror reflects the PADDED edge, so the baked mirror rows
    must cover the radius, or be none), and that shards are taller than
    the halo (``sharded_kernel_chain``'s check, with the same bound).
    More than ``height`` means the image is too small."""
    halo = max(2, *chain.check_chain(cols))
    pad = (-height) % n
    while (0 < pad < halo) or (height + pad) // n < halo + 1:
        pad += n
    return pad


def sharded_kernel_chain(mesh: Mesh, cols, height: int, width: int,
                         batch: int = 0, dtype: str = "uint8"):
    """A fused op chain (``models/chain.py``) over the mesh: one
    ``chain_u8`` or ``chain_f32`` launch a shard on blocks whose halo is
    the chain's radius, ``max(2, ry, rx)``. Returns (op, per-shard
    layout). ``batch=B`` takes ``(b_loc, C, Hp, pitch)`` stacks on the
    full ``(data, space)`` mesh, ``b_loc = B / n_data``; each shard's
    stack runs in one batched launch. Each shard must be taller than the
    chain's radius."""
    if dtype not in ("uint8", "float32"):
        raise ValueError(f"Unknown dtype: {dtype!r}")
    ry, rx = chain.check_chain(cols)
    halo = max(2, ry, rx)
    layout = _shard_layout(_shard_height(mesh, height), width, halo=halo,
                           what=f"a radius-{halo} chain's halo exchange")
    b_loc = 0
    if batch:
        if batch % mesh.n_data:
            raise ValueError(f"the {mesh.n_data}-shard data axis must "
                             f"divide batch {batch}")
        b_loc = batch // mesh.n_data
    make = (chain.make_fused_chain_f32 if dtype == "float32"
            else chain.make_fused_chain)
    op = make(layout, cols, b_loc)
    for device in mesh.distinct:  # the stage descriptors, before any timing
        op.prepare(device)
    return _lift(op, mesh, layout, max(ry, rx) > 0), layout


def sharded_kernel_pipeline(mesh: Mesh, batch: int, height: int, width: int):
    """The fused pipeline (``pipeline_u8``) on the full ``(data, space)``
    mesh: each shard's ``(b_loc, C, Hp, pitch)`` resident stack in one
    launch, after the refresh. Returns (op, per-shard layout)."""
    if batch % mesh.n_data:
        raise ValueError(f"the {mesh.n_data}-shard data axis must divide "
                         f"batch {batch}")
    layout = _shard_layout(_shard_height(mesh, height), width)
    return _lift(fused_pipeline, mesh, layout, True), layout
