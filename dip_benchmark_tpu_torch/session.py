"""Benchmark session: device state and the op table for one image.

The port of ``dip_benchmark_tpu/session.py``, for both data models: uint8
(the default) and float32 (``dtype="float32"``, planar CHW in [0, 1], the
CUDA.jl-parity variant), and both paths: the hand-written kernels
(``path="kernel"``, the JAX package's "pallas") and the library calls
(``path="library"``, its "xla"). It owns the three device-boundary
crossings of the reference design: the untimed initial upload and planar
layout build, the per-round op launch (the measured quantity), and the
download for the image dump.

Every timed round ends in ``torch.cuda.synchronize``, so the rows time
completed device work. On the card the kernel library is built and loaded
here, before any timing; a build failure stops the run.

Besides the benchmark table: ``chained_operations`` (rows that each run K
applications of an op, from one CUDA graph on the card) and
``execution_table`` (each op's device time per application, the slope
over K of ``runtime/exec_timing.py``). Every op of the port maps its
input's shape to itself, so the reference's banded chain and its
``Passthrough`` row have nothing to correct and are not ported; a
shape-changing op is detected and refused.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from . import native, oracle, oracle_f32, spec
from .harness import Operation
from .models import chain
from .ops import OPS, OPS_F32, kernels, library, library_f32
from .runtime import synchronize
from .runtime.exec_timing import (KS, SAMPLES, ExecTime, GraphCache,
                                  chain_direct, execution_time, shapes)
from .utils.image import (check_uint8_hwc, from_planar_padded,
                          from_planar_padded_f32, make_layout,
                          to_planar_padded, to_planar_padded_f32)


def check_session_args(host_image: np.ndarray, dtype: str,
                       path: str) -> None:
    """A session's input contract, as ValueErrors: a uint8 HWC RGB image
    of at least 5x5 (the 5x5 ops' mirrors), a known data model and path."""
    check_uint8_hwc(host_image)
    if min(host_image.shape[:2]) < 5:
        raise ValueError(
            f"image must be at least 5x5 for the 5x5 convolution ops, "
            f"got {host_image.shape[0]}x{host_image.shape[1]}")
    if dtype not in ("uint8", "float32"):
        raise ValueError(f"Unknown dtype: {dtype!r}")
    if path not in ("kernel", "library"):
        raise ValueError(f"Unknown path: {path!r} (want kernel|library)")


class BenchmarkSession:
    """Builds the 14-op table (15 rows with the pipeline) over a host
    image on ``device``.

    path: "kernel" (the CUDA kernels on a CUDA device, their plain PyTorch
    versions on the CPU, over the padded planar) or "library" (PyTorch
    library calls, ``ops/library.py`` and ``ops/library_f32.py``, over the
    unpadded image, which each op mirror-pads itself; on any device).
    dtype: "uint8" (the HWC image bytes move in Upload/Download; the
    kernels' working buffer is the uint8 planar, the library calls' the
    HWC image) or "float32" (the unpadded f32 CHW array of
    ``oracle_f32.from_uint8_hwc`` moves and is the library calls' working
    buffer; the kernels' is the f32 planar, and the ops are
    ``OPS_F32``)."""

    def __init__(self, host_image: np.ndarray, device: torch.device,
                 dtype: str = "uint8", path: str = "kernel"):
        check_session_args(host_image, dtype, path)
        self.host_image = np.ascontiguousarray(host_image)
        self.dtype = dtype
        self.path = path
        self.device = torch.device(device)
        f32 = dtype == "float32"
        if path == "library":
            # Full float32 in the library convolutions: cuDNN's default
            # TF32 breaks the exact fractions of spec.mask_float.
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
            self._ops = (library_f32.IMAGE_OPS_F32 if f32
                         else library.IMAGE_OPS)
            self._crop = _crop_chw if f32 else _crop_hwc
        else:
            if self.device.type == "cuda":
                kernels.load()
            self._ops = OPS_F32 if f32 else OPS
            self._crop = (from_planar_padded_f32 if f32
                          else from_planar_padded)
        self._sample: torch.Tensor | None = None
        self._extra_oracles: dict = {}  # the chain rows' own oracles
        self._chain_exec: tuple | None = None  # set by chain_operation
        self._graphs = GraphCache()  # the chained rows' CUDA graphs
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
        if path == "kernel":
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

    def _device_input(self) -> torch.Tensor:
        """What the ops take: the padded planar on the kernel path; on the
        library path the device copy of the memory ops' payload, the HWC
        image (uint8) or the unpadded f32 CHW array."""
        return self.planar_dev if self.path == "kernel" else self.image_dev

    def _sync(self) -> None:
        """Wait for the session's device: the end of every timed round."""
        synchronize(self.device)

    def _make_run(self, fn: Callable) -> Callable[[], None]:
        src = self._device_input()

        def run():
            self._sample = fn(src)
            self._sync()
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

    def _device_cols(self, include_pipeline: bool) -> list[tuple[str, str]]:
        """(description, column) of every on-device op, in matrix order,
        with the pipeline row last when asked for."""
        cols = [(desc, col) for desc, _, col in spec.OPERATION_MATRIX
                if col not in ("Upload", "Download")]
        if include_pipeline:
            cols.append((PIPELINE_DESCRIPTION, "Fused-Pipeline"))
        return cols

    def _check_shapes(self, cols) -> None:
        """Apply each op once and raise ValueError for any whose output
        shape differs from its input's: K applications chain only when the
        shape is kept. This is also each op's first, untimed launch."""
        src = self._device_input()
        banded = [col for col in cols
                  if shapes(self._ops[col](src)) != shapes(src)]
        if banded:
            raise ValueError(
                f"--chained and --exec need shape-preserving ops; {banded} "
                f"change the shape of their input")

    def chained_operations(self, k: int,
                           include_pipeline: bool = False) -> list[Operation]:
        """Measurement-only table: each timed round runs ``k`` chained
        applications of the op, ``y = op(y)`` (on the card one replay of a
        CUDA graph of the ``k`` launches, captured at the first round and
        cached by op, shape, dtype and ``k``; on the CPU ``k`` plain
        calls), and the row reports per-application time
        (``time_scale=k``). No image dumps: the outputs are k-fold
        applications, not the benchmark's single one."""
        cols = self._device_cols(include_pipeline)
        self._check_shapes([col for _, col in cols])
        ops = []
        for desc, col in cols:
            fn = self._ops[col]
            if self.device.type == "cuda":
                def chained(x, col=col, fn=fn):
                    return self._graphs.replay(self._graph_name(col), fn, x,
                                               k)
            else:
                def chained(x, fn=fn):
                    return chain_direct(fn, x, k)
            ops.append(Operation(desc, "", col, self._make_run(chained),
                                 self._fetch_sample, time_scale=k))
        return ops

    def _graph_name(self, col: str) -> str:
        return f"{self.path}/{self.dtype}/{col}"

    def execution_table(self, include_pipeline: bool = False, ks=KS,
                        samples: int = SAMPLES) -> list[tuple[str, ExecTime]]:
        """[(csv_column, ExecTime)]: each device op's time per application,
        the slope of runs of K chained applications over the K in ``ks``
        (``runtime/exec_timing.py``), in matrix order, then the pipeline
        when asked for, then ``Fused-Chain`` after ``chain_operation``.
        Each op's graphs are dropped once it is timed."""
        cols = [col for _, col in self._device_cols(include_pipeline)]
        self._check_shapes(cols)
        src = self._device_input()
        rows = [(col, execution_time(self._graph_name(col), self._ops[col],
                                     src, ks, samples)) for col in cols]
        if self._chain_exec is not None:
            name, fn, planar = self._chain_exec
            rows.append(("Fused-Chain", execution_time(
                name, fn, planar, ks, samples)))
        return rows

    def pipeline_operation(self) -> Operation:
        """Extra benchmark row: the flagship fused pipeline (grayscale ->
        threshold -> erosion 3x3 -> blur 3x3) as one kernel launch, against
        four launches if chained from the op table. Not part of the
        reference matrix, so it gets no CSV column (the CSV writer skips
        it)."""
        return Operation(
            PIPELINE_DESCRIPTION, "pipeline", "Fused-Pipeline",
            self._make_run(self._ops["Fused-Pipeline"]), self._fetch_output)

    def chain_operation(self, cols: list[str]) -> Operation:
        """Extra benchmark row: an arbitrary op chain (``models/chain.py``)
        as one kernel launch, the user-composable generalization of the
        pipeline row; no CSV column. When the chain's radius exceeds the
        session layout's halo, a deeper-halo planar is baked and put on the
        device here, outside the timed loop, like the initial upload.
        Kernel path only: the library path has no fused chain."""
        if self.path != "kernel":
            raise ValueError("fused chains need --path kernel")
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
        # For execution_table: a chain keeps its planar's shape.
        self._chain_exec = (f"{self.path}/{self.dtype}/chain:"
                            + ",".join(cols), fn, planar)

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
        """The golden ops for --verify, uint8 HWC in and out: for uint8
        the native C++ oracle when it builds, else the NumPy oracle (the
        JAX package's rule: NumPy is too slow for a check every run at
        8 Mpx); for float32 the f32 oracle quantized, whose Fused-Pipeline
        may return (expected, dontcare-mask); merged with the chain rows'
        sequential oracles."""
        if self.dtype == "float32":
            base = oracle_f32.uint8_verify_ops()
        else:
            base = (native.image_ops() if native.available()
                    else oracle.IMAGE_OPS)
        return {**base, **self._extra_oracles}


PIPELINE_DESCRIPTION = "Fused Pipeline (Grayscale+Threshold+Erosion+Blur)"


def _crop_hwc(image: torch.Tensor, layout) -> np.ndarray:
    """The library path's uint8 output is the HWC image itself."""
    return image.cpu().numpy()


def _crop_chw(image: torch.Tensor, layout) -> np.ndarray:
    """The library path's float32 output, the (3, H, W) array in [0, 1],
    quantized to uint8 HWC as the oracle does."""
    return oracle_f32.to_uint8_hwc(image.cpu().numpy())
