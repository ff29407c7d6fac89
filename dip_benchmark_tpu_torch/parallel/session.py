"""The benchmark session over a mesh: the op table with the image's rows
sharded across devices.

The port of ``dip_benchmark_tpu/parallel/session.py``, for both data
models and both paths: "kernel" (the JAX package's "pallas") runs the
unmodified kernels on resident blocks (``parallel/kernel_ops.py``),
"library" (its "xla") plain PyTorch calls on valid-row blocks with the
halo exchanged per op (``parallel/ops.py``). Upload moves the unpadded
``(C, H, W)`` rows to the shards, one host-to-device copy a shard;
Download brings every shard's valid rows back into one host array. Every
timed round ends by synchronizing every device of the mesh.

Everything else is ``session.BenchmarkSession``'s: the table, the
pipeline row, ``--verify``'s oracles and tolerance, and
``execution_table``, whose CUDA graph on the card is one whole sharded
application (every refresh and every block's launch). A graph spans one
device, so ``--exec`` needs a mesh whose shards all sit on one device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import oracle_f32
from ..harness import Operation
from ..models import chain
from ..ops import kernels
from ..runtime.exec_timing import KS, SAMPLES, ExecTime
from ..session import BenchmarkSession, check_session_args
from ..utils.image import from_resident_planar, to_resident_planar
from .halo import Mesh, make_mesh
from .kernel_ops import (build_sharded_kernel_ops, chain_row_padding,
                         sharded_kernel_chain)
from .ops import build_sharded_ops, build_sharded_ops_f32


class ShardedBenchmarkSession(BenchmarkSession):
    """The 14-op table (15 rows with the pipeline) over a ``(space=n,)``
    mesh: ``n_devices`` shards on ``device``'s kind (``make_mesh``), or
    the given ``mesh``. The image's rows are padded to shard evenly.

    It sets up its own state and does not run ``BenchmarkSession``'s
    constructor: there is no single device buffer here."""

    def __init__(self, host_image: np.ndarray, device: torch.device,
                 n_devices: int = 1, mesh: Mesh | None = None,
                 path: str = "kernel", dtype: str = "uint8"):
        check_session_args(host_image, dtype, path)
        self.device = torch.device(device)
        self.mesh = mesh or make_mesh(n_devices, backend=self.device.type)
        if self.mesh.n_data != 1:
            raise ValueError("the sharded session shards rows only: its "
                             "mesh needs n_data == 1")
        n = self.mesh.n_space
        self.host_image = np.ascontiguousarray(host_image)
        self.dtype, self.path = dtype, path
        h, w, c = host_image.shape
        self.valid_height, self.width = h, w
        # Pad rows (high-side mirror: row h+k holds image row h-1-k) so n
        # divides them; crop on fetch. A pad of 1 becomes 1 + n: the
        # bottom shard's mirror reflects the PADDED edge, so a 5x5 tap at
        # the last image row must land on baked mirror rows, not on that
        # reflection.
        pad = (-h) % n
        if pad == 1:
            pad += n
        img = host_image
        if pad:
            img = np.concatenate([img, img[h - pad:][::-1]], axis=0)
        planar = np.transpose(img, (2, 0, 1))  # (C, Hs, W)
        if planar.shape[1] // n < 3:
            raise ValueError(
                f"{planar.shape[1]} rows over {n} shards leaves "
                f"{planar.shape[1] // n} rows per shard; halo exchange "
                f"needs >= 3 — use fewer devices or a taller image")
        if dtype == "float32":
            # u8 / 255 on the host, as the unsharded session's bake.
            planar = planar.astype(np.float32) / np.float32(255)
        self.host_planar = np.ascontiguousarray(planar)
        self.h_loc = h_loc = planar.shape[1] // n
        # The memory ops' payload: each shard's unpadded rows, contiguous.
        self._host_blocks = tuple(
            torch.from_numpy(np.ascontiguousarray(
                planar[:, i * h_loc:(i + 1) * h_loc])) for i in range(n))
        if path == "kernel":
            if any(d.type == "cuda" for d in self.mesh.distinct):
                kernels.load()
            self._ops, self.layout = build_sharded_kernel_ops(
                self.mesh, planar.shape[1], w, dtype)
            blocks = to_resident_planar(planar, self.layout, n)
        else:
            self._ops = (build_sharded_ops_f32 if dtype == "float32"
                         else build_sharded_ops)(self.mesh)
            self.layout = None
            blocks = self._host_blocks
        self.blocks = self._to_mesh(blocks)
        self._crop = self._crop_blocks
        self._sample = None
        self._extra_oracles: dict = {}
        self._chain_exec: tuple | None = None
        self.mesh.synchronize()

    def _to_mesh(self, blocks) -> tuple[torch.Tensor, ...]:
        """Fresh copies of host blocks, each on its shard's device."""
        return tuple(b.to(d, copy=True) for b, d in zip(blocks,
                                                         self.mesh.flat))

    def _sync(self) -> None:
        self.mesh.synchronize()

    # -- memory ops --------------------------------------------------------

    def _upload(self) -> tuple[torch.Tensor, ...]:
        out = self._to_mesh(self._host_blocks)
        self._sync()
        return out

    def _download(self) -> np.ndarray:
        c, hs, w = self.host_planar.shape
        host = torch.empty((c, hs, w), dtype=self._host_blocks[0].dtype)
        h_loc = self.h_loc
        p = 0 if self.layout is None else self.layout.pad
        for i, b in enumerate(self.blocks):
            host[:, i * h_loc:(i + 1) * h_loc].copy_(
                b[:, p:p + h_loc, p:p + w])
        return host[:, :self.valid_height].numpy()

    # -- table -------------------------------------------------------------

    def _device_input(self) -> tuple[torch.Tensor, ...]:
        return self.blocks

    def _crop_blocks(self, blocks, layout) -> np.ndarray:
        """A sharded output's valid rows and columns as uint8 HWC: the
        resident blocks on ``layout``, or valid-row blocks (``layout``
        None, the library path)."""
        if layout is None:
            arr = torch.cat([b.cpu() for b in blocks], dim=-2)[
                :, :self.valid_height].numpy()
        else:
            arr = from_resident_planar(blocks, layout, layout.height,
                                       height=self.valid_height)
        if self.dtype == "float32":
            return oracle_f32.to_uint8_hwc(arr)
        return np.ascontiguousarray(np.transpose(arr, (1, 2, 0)))

    def chain_operation(self, cols: list[str]) -> Operation:
        """The ``--fuse`` row over the mesh (kernel path only): one fused
        chain launch a shard (``sharded_kernel_chain``) on resident
        blocks with the chain's halo. The chain gets its own row padding,
        outside the timed loop: the bottom shard's mirror reflects the
        PADDED edge, so the baked mirror rows must cover the chain's
        vertical radius (or be none, the padded edge then being the
        image's), and shards must be taller than the halo."""
        if self.path != "kernel":
            raise ValueError("--fuse with --shards needs --path kernel")
        ry, rx = chain.check_chain(cols)
        n, h = self.mesh.n_space, self.valid_height
        base = self.host_planar[:, :h]
        pad = chain_row_padding(h, n, cols)
        if pad > h:
            raise ValueError(
                f"image of {h} rows is too small for a chain needing "
                f"{max(ry, rx, 2)}-row halos (ry={ry}, rx={rx}) over {n} "
                f"shards")
        planar = (base if pad == 0 else np.concatenate(
            [base, base[:, h - pad:][:, ::-1]], axis=1))
        fn, layout = sharded_kernel_chain(self.mesh, cols, planar.shape[1],
                                          self.width, dtype=self.dtype)
        blocks = self._to_mesh(to_resident_planar(planar, layout, n))
        self._sync()
        self._chain_exec = (f"{self.path}/{self.dtype}/shards{n}/chain:"
                            + ",".join(cols), fn, blocks)

        def run():
            self._sample = fn(blocks)
            self._sync()

        desc, col, seq_oracle = chain.chain_row_parts(cols, dtype=self.dtype)
        self._extra_oracles[col] = seq_oracle
        return Operation(desc, "chain", col, run,
                         lambda: self._crop_blocks(self._sample, layout))

    def chained_operations(self, k: int, include_pipeline: bool = False):
        raise ValueError("--chained has no --shards route")

    def execution_table(self, include_pipeline: bool = False, ks=KS,
                        samples: int = SAMPLES) -> list[tuple[str, ExecTime]]:
        """``BenchmarkSession.execution_table`` over the mesh: an
        application is the whole sharded op. Refused (ValueError) on a
        mesh over several devices: a CUDA graph spans one."""
        if len(self.mesh.distinct) > 1:
            raise ValueError(
                f"--exec with --shards needs every shard on one device (a "
                f"CUDA graph spans one); this mesh spans "
                f"{len(self.mesh.distinct)}")
        return super().execution_table(include_pipeline, ks, samples)
