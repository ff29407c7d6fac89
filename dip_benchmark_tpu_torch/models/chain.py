"""Fused op chains: any sequence of the matrix's device ops as one kernel.

The port of ``dip_benchmark_tpu/models/chain.py``. A chain of CSV columns
(``--fuse COL,COL,...`` on the CLI, ``--op A,B,...`` in the batch tool)
is lowered to a list of stages, each one of

- a point stage: ``copy``, ``invert`` or ``threshold``;
- ``min``: the min over a 3x3 structuring element (cross or square);
- ``conv``: a correlation with a ``kh x kw`` integer mask and its shift,
  ``kh, kw <= 5``: dense (3x3, 5x5), or one pass of a separated
  convolution (1xN, then Nx1).

The stages follow the JAX package's stage forms, not the standalone ops,
where the two differ: ``Erosion-1x3+3x1-Square`` is the 3x3 square (min
separability), ``Gaussian-Blur-3x3`` is the dense 3x3 convolution, and a
separated convolution is two stages, each rounded to u8 in the uint8
model and unrounded in the float32 one. Both data models lower a chain to
the same stages: the data model picks the arithmetic. uint8 rounds every
stage, ``(acc + half) >> shift`` clamped; float32 multiplies by the mask
``int / 2**shift`` and sums each column over ``ky`` first, then the
columns over ``kx``, the order of the JAX stage ``_conv_rank1_f32`` and of
``ops/f32.conv_dense_plain`` (not the standalone blur's, whose weights
``ops/f32.blur3x3_plain`` applies in another order). "Grayscale" may come
only first: its luma then fills one plane, the stages run once on it, and
the result goes to all three planes.

``make_fused_chain`` and ``make_fused_chain_f32`` return a ``FusedChain``
for one layout: a function of the planar tensor that launches
``chain_u8`` or ``chain_f32`` (``ops/kernels/csrc/chain.cu``) for a CUDA
tensor and runs ``fused_chain_plain`` for a CPU tensor. Like every
windowed op of the port the output has the input's shape: the composed
stages wherever all their taps lie in the buffer, 0 in the outer ring of
``Ry`` rows and ``Rx`` columns, ``(Ry, Rx)`` being the sums of the
stages' radii. The stage descriptors travel to the kernel in a small
int32 device tensor, uploaded once per chain and device (``prepare``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import oracle, oracle_f32, spec
from ..ops import f32, kernels, point, window
from ..utils.image import PlanarLayout

# The deepest chain halo either package accepts. The JAX package's bound is
# its banded DMA window (DMA_SLACK // 2 = 8 rows a side); the port keeps
# the same number so both accept and refuse the same chains. It also sizes
# the kernel's shared-memory tile (csrc/chain.cu kMaxRadius).
MAX_CHAIN_RADIUS = 8

# Stage kind -> the code csrc/chain.cu reads.
KINDS = {"copy": 0, "invert": 1, "threshold": 2, "min": 3, "conv": 4}
_POINT = np.zeros((1, 1), np.int32)


class Stage(NamedTuple):
    kind: str
    mask: np.ndarray = _POINT  # (kh, kw): taps of "min", weights of "conv"
    shift: int = 0             # "conv": the mask is int_mask / 2**shift

    @property
    def ry(self) -> int:
        return self.mask.shape[0] // 2

    @property
    def rx(self) -> int:
        return self.mask.shape[1] // 2


def _conv_separated(row_mask: np.ndarray, shift: int) -> list[Stage]:
    """The 1xN pass, then the Nx1 pass, with the row mask for both (every
    benchmark mask is symmetric), as the JAX stages build them."""
    w = np.asarray(row_mask, np.int32).reshape(1, -1)
    return [Stage("conv", w, shift), Stage("conv", w.T.copy(), shift)]


def _stages_for(col: str) -> list[Stage]:
    if col == "Copy":
        return [Stage("copy")]
    if col == "Inversion":
        return [Stage("invert")]
    if col == "Threshold":
        return [Stage("threshold")]
    if col == "Erosion-3x3-Cross":
        return [Stage("min", spec.CROSS_MASK_3X3.astype(np.int32))]
    if col in ("Erosion-3x3-Square", "Erosion-1x3+3x1-Square"):
        # min separability: the 1x3+3x1 two-pass op IS the 3x3 square.
        return [Stage("min", spec.SQUARE_MASK_3X3.astype(np.int32))]
    if col in ("Convolution-3x3", "Gaussian-Blur-3x3"):
        # op #14 shares Convolution-3x3's semantics.
        return [Stage("conv", spec.BLUR_3X3_INT.astype(np.int32),
                      spec.BLUR_3X3_SHIFT)]
    if col == "Convolution-5x5":
        return [Stage("conv", spec.BLUR_5X5_INT.astype(np.int32),
                      spec.BLUR_5X5_SHIFT)]
    if col == "Convolution-1x3+3x1":
        return _conv_separated(spec.BLUR_1X3_INT, spec.BLUR_SEP3_SHIFT)
    if col == "Convolution-1x5+5x1":
        return _conv_separated(spec.BLUR_1X5_INT, spec.BLUR_SEP5_SHIFT)
    raise ValueError(f"op not fusable in a chain: {col!r}")


def _chain_stages(cols) -> tuple[bool, list[Stage]]:
    if not cols:
        raise ValueError("empty chain")
    gray_first = cols[0] == "Grayscale"
    rest = cols[1:] if gray_first else cols
    if "Grayscale" in rest:
        raise ValueError("Grayscale may appear only as the first stage "
                         "of a fused chain (it is cross-channel)")
    stages: list[Stage] = []
    for col in rest:
        stages.extend(_stages_for(col))
    return gray_first, stages


def chain_radius(cols) -> tuple[int, int]:
    """(ry, rx): the chain's total vertical and horizontal radius, the
    halo its input layout must be baked with (``make_layout(h, w,
    pad=...)``)."""
    _, stages = _chain_stages(cols)
    return sum(s.ry for s in stages), sum(s.rx for s in stages)


def check_chain(cols) -> tuple[int, int]:
    """Fusability, stage order and the radius bound; raises ValueError
    with the reason, returns (ry, rx)."""
    ry, rx = chain_radius(cols)
    if max(ry, rx) > MAX_CHAIN_RADIUS:
        raise ValueError(
            f"chain radius (ry={ry}, rx={rx}) exceeds the fused-chain halo "
            f"bound ({MAX_CHAIN_RADIUS}); shorten the chain")
    return ry, rx


def chain_row_parts(cols, dtype: str = "uint8"):
    """(description, csv_column, sequential_oracle) of a benchmark-table
    chain row, as the JAX package names them. The CSV column embeds the
    chain, so each chain row verifies against its own oracle and the CSV
    writer, which keeps only ``spec.CSV_COLUMNS``, skips it. For float32
    the oracle chains the f32 ops on the raw f32 intermediate, and returns
    ``(expected, dontcare)`` where a Threshold follows a computed value:
    pixels within ulps of the 0.5 step may flip with the association order
    (``oracle_f32.near_threshold_mask``), spread by the chain's radius."""
    cols = tuple(cols)
    desc = "Fused Chain (" + "+".join(
        c.replace("Convolution-", "Conv").replace("Erosion-", "Ero")
        for c in cols) + ")"
    col = "Fused-Chain(" + "+".join(cols) + ")"

    if dtype == "float32":
        def seq_oracle(im):
            x = oracle_f32.from_uint8_hwc(im)
            mask = None
            for i, c in enumerate(cols):
                if c == "Threshold" and i > 0:
                    m = oracle_f32.near_threshold_mask(x)
                    mask = m if mask is None else (mask | m)
                x = oracle_f32.IMAGE_OPS_F32[c](x)
            out = oracle_f32.to_uint8_hwc(x)
            if mask is not None and mask.any():
                mask = oracle_f32.dilate_mask(mask, *chain_radius(cols))
                return out, np.broadcast_to(mask[..., None], out.shape)
            return out
    else:
        def seq_oracle(im):
            for c in cols:
                im = oracle.IMAGE_OPS[c](im)
            return im

    return desc, col, seq_oracle


# -- plain PyTorch version -------------------------------------------------

def _stage_plain(stage: Stage, planar: torch.Tensor,
                 float32: bool) -> torch.Tensor:
    """One stage on the whole (C, Hp, pitch) buffer, 0 in its own ring."""
    if stage.kind == "copy":
        return planar
    if stage.kind == "invert":
        return (f32.inversion_plain if float32
                else point.inversion_plain)(planar)
    if stage.kind == "threshold":
        return (f32.threshold_plain if float32
                else point.threshold_plain)(planar)
    if stage.kind == "min":
        return window.erosion_plain(planar, stage.mask.astype(bool))
    return (f32.conv_dense_plain if float32
            else window.conv_dense_plain)(planar, stage.mask, stage.shift)


def fused_chain_plain(planar: torch.Tensor, cols,
                      dtype: str = "uint8") -> torch.Tensor:
    """The chain as the data model's plain stages composed one after
    another on the whole buffer, then the outer ``(Ry, Rx)`` ring set to
    0; one image ``(C, Hp, pitch)`` or a stack. Inside the ring no stage
    reads another's zero ring, so this is the kernel's function."""
    gray_first, stages = _chain_stages(cols)
    float32 = dtype == "float32"
    ry, rx = sum(s.ry for s in stages), sum(s.rx for s in stages)

    def single(p: torch.Tensor) -> torch.Tensor:
        if gray_first:
            p = (f32.grayscale_plain if float32 else point.grayscale_plain)(p)
        for s in stages:
            p = _stage_plain(s, p, float32)
        return window.zero_ring(p.clone(), ry, rx)

    if planar.dim() == 4:
        return torch.stack([single(p) for p in planar])
    return single(planar)


# -- the kernel's wrapper --------------------------------------------------

def _rank1_payload(stage: Stage) -> np.ndarray:
    """A uint8 conv stage's factors u (kh) then v (kw), from
    ``ops/window.rank1_factors``; ValueError where csrc/chain.cu has no
    body for the mask: it does not factor into nonnegative integers, or a
    16-bit field of its sums, rounding add included, could reach 2^16."""
    uv = window.rank1_factors(stage.mask)
    half = (1 << stage.shift) >> 1
    if (uv is None or stage.shift > 15
            or 255 * int(stage.mask.sum()) + half >= 1 << 16):
        raise ValueError(f"chain_u8 takes a conv mask only as nonnegative "
                         f"rank-1 integer factors within the packed-16 "
                         f"bound; this one has none:\n{stage.mask}")
    return np.concatenate(uv)


def _encode(stages: list[Stage], float32: bool) -> np.ndarray:
    """The stage list as csrc/chain.cu reads it: per stage the words kind,
    kh, kw, shift, then its payload: the one weight 0 of a point stage, the
    kh * kw taps of a "min", and for a "conv" the rank-1 factors u (kh
    words) then v (kw words) of its integer mask, or in float32 the bits
    of its kh * kw weights int / 2**shift. Raises ValueError for a uint8
    conv stage whose mask has no such factors."""
    words: list[int] = []
    for s in stages:
        kh, kw = s.mask.shape
        words += [KINDS[s.kind], kh, kw, s.shift]
        payload = np.asarray(s.mask, np.int32)
        if s.kind == "conv":
            payload = (spec.mask_float(s.mask, s.shift).astype(
                np.float32).view(np.int32) if float32
                else _rank1_payload(s))
        words += payload.ravel().tolist()
    return np.asarray(words, np.int32)


class FusedChain:
    """A chain built for one layout: ``chain(planar)`` takes the layout's
    ``(C, Hp, pitch)`` tensor, or with ``batch=B`` a ``(B, C, Hp, pitch)``
    stack, and returns a tensor of the same shape, in one launch."""

    def __init__(self, layout: PlanarLayout, cols, dtype: str,
                 batch: int = 0):
        self.cols = list(cols)
        self.dtype = dtype
        self.gray_first, stages = _chain_stages(self.cols)
        self.ry = sum(s.ry for s in stages)
        self.rx = sum(s.rx for s in stages)
        if max(self.ry, self.rx) > layout.pad:
            raise ValueError(
                f"chain radius (ry={self.ry}, rx={self.rx}) exceeds the "
                f"layout halo ({layout.pad}); shorten the chain or enlarge "
                f"the halo")
        if self.gray_first and layout.channels != 3:
            raise ValueError("a Grayscale-first chain needs 3 planes")
        self.shape = ((batch,) if batch else ()) + layout.shape
        self.n_stages = len(stages)
        words = _encode(stages, dtype == "float32")
        self._words = torch.from_numpy(words)
        self._host_words = (ctypes.c_int * len(words))(*words.tolist())
        self._device_words: dict[torch.device, torch.Tensor] = {}

    @property
    def kernel(self) -> str:
        return "chain_f32" if self.dtype == "float32" else "chain_u8"

    def prepare(self, device) -> "FusedChain":
        """Put the stage descriptors on ``device`` (a CUDA device) now,
        outside any timed loop; the first call does it otherwise."""
        device = torch.device(device)
        if device.type == "cuda" and device not in self._device_words:
            self._device_words[device] = self._words.to(device)
        return self

    def __call__(self, planar: torch.Tensor) -> torch.Tensor:
        float32 = self.dtype == "float32"
        kernels.check_planar(planar, batched=True,
                             dtype=torch.float32 if float32 else torch.uint8)
        if tuple(planar.shape) != self.shape:
            raise ValueError(f"chain built for {self.shape}, got "
                             f"{tuple(planar.shape)}")
        if kernels.on_cpu(planar):
            return fused_chain_plain(planar, self.cols, self.dtype)
        words = self.prepare(planar.device)._device_words[planar.device]
        out = torch.empty_like(planar)
        c, hp, pitch = planar.shape[-3:]
        images = planar.shape[0] if planar.dim() == 4 else 1
        count = images if self.gray_first else images * c
        if float32:
            luma = f32.LUMA
            entry = "dip_chain_f32"
        else:
            luma = (*spec.GRAYSCALE_WEIGHTS_INT_RGB, spec.GRAYSCALE_SHIFT)
            entry = "dip_chain_u8"
        kernels.launch(self.kernel, entry, planar.device, planar.data_ptr(),
                       out.data_ptr(), count, hp, pitch,
                       int(self.gray_first), words.data_ptr(),
                       self._host_words, len(self._host_words), *luma)
        return out


def make_fused_chain(layout: PlanarLayout, cols, batch: int = 0) -> FusedChain:
    """The uint8 chain of ``cols`` on ``layout`` (``chain_u8``)."""
    return FusedChain(layout, cols, "uint8", batch)


def make_fused_chain_f32(layout: PlanarLayout, cols,
                         batch: int = 0) -> FusedChain:
    """The float32 chain of ``cols`` on ``layout`` (``chain_f32``): no
    rounding between stages."""
    return FusedChain(layout, cols, "float32", batch)
