"""Benchmark session: device state and the 14-op table for one image.

The port of the uint8 kernel path of ``dip_benchmark_tpu/session.py``. It
owns the three device-boundary crossings of the reference design: the
untimed initial upload and planar layout build, the per-round op launch
(the measured quantity), and the download for the image dump.

Every timed round ends in ``torch.cuda.synchronize``, so the rows time
completed device work. On the card the kernel library is built and loaded
here, before any timing; a build failure stops the run.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from dip_benchmark_tpu import native, oracle, spec
from dip_benchmark_tpu.harness import Operation

from .ops import OPS, kernels
from .runtime import synchronize
from .utils.image import (check_uint8_hwc, from_planar_padded, make_layout,
                          to_planar_padded)


class BenchmarkSession:
    """Builds the 14-op table over a host image on ``device``: the CUDA
    kernels on a CUDA device, their plain PyTorch versions on the CPU."""

    verify_atol = 0  # the uint8 model is bit-exact

    def __init__(self, host_image: np.ndarray, device: torch.device):
        check_uint8_hwc(host_image)
        if min(host_image.shape[:2]) < 5:
            raise ValueError(
                f"image must be at least 5x5 for the 5x5 convolution ops, "
                f"got {host_image.shape[0]}x{host_image.shape[1]}")
        self.host_image = np.ascontiguousarray(host_image)
        self.device = torch.device(device)
        if self.device.type == "cuda":
            kernels.load()
        self._sample: torch.Tensor | None = None

        # (a) initial upload: untimed session state (the Upload op re-does
        # this transfer every round).
        self.image_dev = self._upload()
        h, w, c = host_image.shape
        self.layout = make_layout(h, w, c)
        self.planar_dev = to_planar_padded(self.host_image, self.layout).to(
            self.device)
        synchronize(self.device)

    # -- memory ops --------------------------------------------------------

    def _upload(self) -> torch.Tensor:
        out = torch.from_numpy(self.host_image).to(self.device, copy=True)
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

    def operations(self) -> list[Operation]:
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
                                     self._make_run(OPS[col]),
                                     self._fetch_output))
        return ops

    def _fetch_output(self) -> np.ndarray:
        return from_planar_padded(self._sample, self.layout)

    def _fetch_sample(self) -> np.ndarray:
        raise RuntimeError("memory ops produce no image")  # prefix == ""

    @staticmethod
    def oracle_ops() -> dict:
        """The golden ops for --verify: the native C++ oracle when it
        builds, else the NumPy one (bit-identical, tested)."""
        return native.image_ops() if native.available() else oracle.IMAGE_OPS
