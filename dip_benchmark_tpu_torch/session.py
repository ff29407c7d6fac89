"""Benchmark session: device state and the op table for one image.

The port of the kernel path of ``dip_benchmark_tpu/session.py``, for both
data models: uint8 (the default) and float32 (``dtype="float32"``, planar
CHW in [0, 1], the CUDA.jl-parity variant). It owns the three
device-boundary crossings of the reference design: the untimed initial
upload and planar layout build, the per-round op launch (the measured
quantity), and the download for the image dump.

Every timed round ends in ``torch.cuda.synchronize``, so the rows time
completed device work. On the card the kernel library is built and loaded
here, before any timing; a build failure stops the run.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from . import oracle, oracle_f32, spec
from .harness import Operation
from .models import chain
from .ops import OPS, OPS_F32, kernels
from .runtime import synchronize
from .utils.image import (check_uint8_hwc, from_planar_padded,
                          from_planar_padded_f32, make_layout,
                          to_planar_padded, to_planar_padded_f32)


class BenchmarkSession:
    """Builds the 14-op table (15 rows with the pipeline) over a host
    image on ``device``: the CUDA kernels on a CUDA device, their plain
    PyTorch versions on the CPU.

    dtype: "uint8" (the HWC image bytes move in Upload/Download, the
    working buffer is the uint8 planar) or "float32" (the unpadded f32 CHW
    array of ``oracle_f32.from_uint8_hwc`` moves, the working buffer is
    the f32 planar, and the ops are ``OPS_F32``)."""

    def __init__(self, host_image: np.ndarray, device: torch.device,
                 dtype: str = "uint8"):
        check_uint8_hwc(host_image)
        if min(host_image.shape[:2]) < 5:
            raise ValueError(
                f"image must be at least 5x5 for the 5x5 convolution ops, "
                f"got {host_image.shape[0]}x{host_image.shape[1]}")
        if dtype not in ("uint8", "float32"):
            raise ValueError(f"Unknown dtype: {dtype!r}")
        self.host_image = np.ascontiguousarray(host_image)
        self.dtype = dtype
        self.device = torch.device(device)
        if self.device.type == "cuda":
            kernels.load()
        self._sample: torch.Tensor | None = None
        self._extra_oracles: dict = {}  # the chain rows' own oracles
        f32 = dtype == "float32"
        self._ops = OPS_F32 if f32 else OPS
        self._crop = from_planar_padded_f32 if f32 else from_planar_padded
        # The memory ops' payload: the data model's image on the host (the
        # CUDA.jl backend uploads the host-converted Float32 array,
        # cuda/benchmark.jl:171-173).
        # Row-major (3, H, W) as the JAX package's device_put holds it:
        # from_uint8_hwc returns a transposed (HWC-ordered) view.
        self._mem_host = torch.from_numpy(np.ascontiguousarray(
            oracle_f32.from_uint8_hwc(self.host_image)) if f32
            else self.host_image)

        # (a) initial upload: untimed session state (the Upload op re-does
        # this transfer every round).
        self.image_dev = self._upload()
        h, w, c = host_image.shape
        self.layout = make_layout(h, w, c)
        self._bake = to_planar_padded_f32 if f32 else to_planar_padded
        self.planar_dev = self._bake(self.host_image,
                                     self.layout).to(self.device)
        synchronize(self.device)

    @property
    def verify_atol(self) -> int:
        """0 for the uint8 model (bit-exact contract); 1 for float32, where
        another association of a float sum may differ from the NumPy oracle
        by an ulp, which the final u8 quantization can turn into 1 level."""
        return 1 if self.dtype == "float32" else 0

    # -- memory ops --------------------------------------------------------

    def _upload(self) -> torch.Tensor:
        out = self._mem_host.to(self.device, copy=True)
        synchronize(self.device)
        return out

    def _download(self) -> np.ndarray:
        # A fresh device-to-host copy every round.
        return self.image_dev.to("cpu", copy=True).numpy()

    # -- table -------------------------------------------------------------

    def _make_run(self, fn: Callable) -> Callable[[], None]:
        def run():
            self._sample = fn(self.planar_dev)
            synchronize(self.device)
        return run

    def operations(self, include_pipeline: bool = False) -> list[Operation]:
        ops: list[Operation] = []
        for desc, prefix, col in spec.OPERATION_MATRIX:
            if col == "Upload":
                ops.append(Operation(desc, prefix, col, self._upload,
                                     self._fetch_sample))
            elif col == "Download":
                ops.append(Operation(desc, prefix, col, self._download,
                                     self._fetch_sample, downloads=True))
            else:
                ops.append(Operation(desc, prefix, col,
                                     self._make_run(self._ops[col]),
                                     self._fetch_output))
        if include_pipeline:
            ops.append(self.pipeline_operation())
        return ops

    def pipeline_operation(self) -> Operation:
        """Extra benchmark row: the flagship fused pipeline (grayscale ->
        threshold -> erosion 3x3 -> blur 3x3) as one kernel launch, against
        four launches if chained from the op table. Not part of the
        reference matrix, so it gets no CSV column (the CSV writer skips
        it)."""
        return Operation(
            "Fused Pipeline (Grayscale+Threshold+Erosion+Blur)", "pipeline",
            "Fused-Pipeline", self._make_run(self._ops["Fused-Pipeline"]),
            self._fetch_output)

    def chain_operation(self, cols: list[str]) -> Operation:
        """Extra benchmark row: an arbitrary op chain (``models/chain.py``)
        as one kernel launch, the user-composable generalization of the
        pipeline row; no CSV column. When the chain's radius exceeds the
        session layout's halo, a deeper-halo planar is baked and put on the
        device here, outside the timed loop, like the initial upload."""
        ry, rx = chain.check_chain(cols)
        r = max(ry, rx)
        if r <= self.layout.pad:
            layout, planar = self.layout, self.planar_dev
        else:
            h, w, c = self.host_image.shape
            if min(h, w) < r + 1:
                # spec.mirror_index is only defined for offsets <= dim - 1.
                raise ValueError(
                    f"image {h}x{w} is too small for a radius-{r} fused "
                    f"chain (mirror halo needs both dims >= {r + 1}); "
                    f"shorten the chain or run the ops sequentially")
            layout = make_layout(h, w, c, pad=r)
            planar = self._bake(self.host_image, layout).to(self.device)
            synchronize(self.device)
        make = (chain.make_fused_chain_f32 if self.dtype == "float32"
                else chain.make_fused_chain)
        fn = make(layout, cols).prepare(self.device)

        def run():
            self._sample = fn(planar)
            synchronize(self.device)

        desc, col, seq_oracle = chain.chain_row_parts(cols, dtype=self.dtype)
        self._extra_oracles[col] = seq_oracle
        return Operation(desc, "chain", col, run,
                         lambda: self._crop(self._sample, layout))

    def _fetch_output(self) -> np.ndarray:
        return self._crop(self._sample, self.layout)

    def _fetch_sample(self) -> np.ndarray:
        raise RuntimeError("memory ops produce no image")  # prefix == ""

    def oracle_ops(self) -> dict:
        """The golden ops for --verify, uint8 HWC in and out: the port's
        NumPy oracle, or for float32 its f32 oracle quantized, whose
        Fused-Pipeline may return (expected, dontcare-mask); merged with
        the chain rows' sequential oracles."""
        base = (oracle_f32.uint8_verify_ops() if self.dtype == "float32"
                else oracle.IMAGE_OPS)
        return {**base, **self._extra_oracles}
