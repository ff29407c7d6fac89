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
        f32 = dtype == "float32"
        self._ops = OPS_F32 if f32 else OPS
        self._crop = from_planar_padded_f32 if f32 else from_planar_padded
        # The memory ops' payload: the data model's image on the host (the
        # CUDA.jl backend uploads the host-converted Float32 array,
        # cuda/benchmark.jl:171-173).
        self._mem_host = torch.from_numpy(
            oracle_f32.from_uint8_hwc(self.host_image) if f32
            else self.host_image)

        # (a) initial upload: untimed session state (the Upload op re-does
        # this transfer every round).
        self.image_dev = self._upload()
        h, w, c = host_image.shape
        self.layout = make_layout(h, w, c)
        bake = to_planar_padded_f32 if f32 else to_planar_padded
        self.planar_dev = bake(self.host_image, self.layout).to(self.device)
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

    def _fetch_output(self) -> np.ndarray:
        return self._crop(self._sample, self.layout)

    def _fetch_sample(self) -> np.ndarray:
        raise RuntimeError("memory ops produce no image")  # prefix == ""

    def oracle_ops(self) -> dict:
        """The golden ops for --verify, uint8 HWC in and out: the port's
        NumPy oracle, or for float32 its f32 oracle quantized, whose
        Fused-Pipeline may return (expected, dontcare-mask)."""
        if self.dtype == "float32":
            return oracle_f32.uint8_verify_ops()
        return oracle.IMAGE_OPS
