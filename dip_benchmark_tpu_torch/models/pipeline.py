"""The flagship model: the fused DIP pipeline, one kernel.

grayscale -> threshold -> erosion (3x3 square) -> Gaussian blur (3x3) over
the planar padded image, the port of the JAX package's
``models/pipeline.py`` (``make_fused_pipeline_pallas``): one read of the
three planes, all four stages on chip, one write, instead of four kernels
and four round trips through device memory.

``fused_pipeline`` takes one image ``(3, Hp, pitch)`` or a stack
``(B, 3, Hp, pitch)`` and returns a tensor of the same shape. For a CUDA
tensor it launches ``pipeline_u8`` (``ops/kernels/csrc/pipeline.cu``) once,
whatever B is; for a CPU tensor it runs ``fused_pipeline_plain``, the same
whole-buffer function in plain PyTorch. Like every windowed op of the port,
the output is the pipeline where all its taps lie in the buffer and 0 in
the outer ring of 2 rows and 2 columns, and its crop is
``oracle.fused_pipeline`` of the image.
"""

from __future__ import annotations

import torch

from .. import spec
from ..ops import kernels, point, window

RING = 2  # erosion radius 1 + blur radius 1


def _single_plain(planar: torch.Tensor) -> torch.Tensor:
    gray = point.grayscale_plain(planar)
    mask = point.threshold_plain(gray)
    eroded = window.erosion_plain(mask, spec.SQUARE_MASK_3X3)
    out = window.blur3x3_plain(eroded)
    # The blur at rows and columns 1 and -2 reads the erosion's zero ring;
    # the kernel writes 0 there, and so does this version.
    out[:, :RING] = 0
    out[:, -RING:] = 0
    out[:, :, :RING] = 0
    out[:, :, -RING:] = 0
    return out


def fused_pipeline_plain(planar: torch.Tensor) -> torch.Tensor:
    """The port's plain grayscale, threshold, square erosion and blur
    composed, with the outer 2-ring set to 0; one image or a stack."""
    if planar.dim() == 4:
        return torch.stack([_single_plain(p) for p in planar])
    return _single_plain(planar)


def fused_pipeline(planar: torch.Tensor) -> torch.Tensor:
    kernels.check_planar(planar, channels=3, batched=True)
    if kernels.on_cpu(planar):
        return fused_pipeline_plain(planar)
    out = torch.empty_like(planar)
    batch = planar.shape[0] if planar.dim() == 4 else 1
    _, hp, pitch = planar.shape[-3:]
    kernels.launch("pipeline_u8", "dip_pipeline_u8", planar.device,
                   planar.data_ptr(), out.data_ptr(), batch, hp, pitch)
    return out
