"""Point ops on the planar padded image: copy, inversion, threshold, grayscale.

Each op has a wrapper that launches its CUDA kernel (``kernels/csrc/
point.cu``) for a tensor on the card, and a plain PyTorch version of the
same function (``*_plain``) that the wrapper takes only for a tensor on the
CPU. Both run over the whole padded buffer, halo included: point ops
commute with mirroring, so the output's halo stays a valid mirror.
"""

from __future__ import annotations

import torch

from .. import spec
from ..runtime import tracing
from . import kernels


# -- plain PyTorch versions ------------------------------------------------

def copy_plain(planar: torch.Tensor) -> torch.Tensor:
    return planar.clone()


def inversion_plain(planar: torch.Tensor) -> torch.Tensor:
    return 255 - planar


def threshold_plain(planar: torch.Tensor) -> torch.Tensor:
    return torch.where(planar > spec.THRESHOLD_VALUE,
                       spec.THRESHOLD_MAX, 0).to(torch.uint8)


def grayscale_plain(planar: torch.Tensor) -> torch.Tensor:
    r, g, b = planar.to(torch.int32)
    wr, wg, wb = spec.GRAYSCALE_WEIGHTS_INT_RGB
    gray = (wr * r + wg * g + wb * b) >> spec.GRAYSCALE_SHIFT
    return gray.to(torch.uint8).expand(3, -1, -1).contiguous()


# -- wrappers --------------------------------------------------------------

def copy(planar: torch.Tensor) -> torch.Tensor:
    kernels.check_planar(planar)
    if kernels.on_cpu(planar):
        return copy_plain(planar)
    out = tracing.call("alloc", torch.empty_like, planar)
    kernels.launch("copy_u8", "dip_copy_u8", planar.device,
                   planar.data_ptr(), out.data_ptr(), planar.numel() // 16)
    return out


def inversion(planar: torch.Tensor) -> torch.Tensor:
    kernels.check_planar(planar)
    if kernels.on_cpu(planar):
        return inversion_plain(planar)
    out = tracing.call("alloc", torch.empty_like, planar)
    kernels.launch("point_u8<Invert>", "dip_inversion_u8", planar.device,
                   planar.data_ptr(), out.data_ptr(), planar.numel() // 16)
    return out


def threshold(planar: torch.Tensor) -> torch.Tensor:
    kernels.check_planar(planar)
    if kernels.on_cpu(planar):
        return threshold_plain(planar)
    out = tracing.call("alloc", torch.empty_like, planar)
    kernels.launch("point_u8<Threshold>", "dip_threshold_u8", planar.device,
                   planar.data_ptr(), out.data_ptr(), planar.numel() // 16,
                   spec.THRESHOLD_VALUE, spec.THRESHOLD_MAX)
    return out


def grayscale(planar: torch.Tensor) -> torch.Tensor:
    kernels.check_planar(planar, channels=3)
    if kernels.on_cpu(planar):
        return grayscale_plain(planar)
    out = tracing.call("alloc", torch.empty_like, planar)
    kernels.launch("grayscale_u8", "dip_grayscale_u8", planar.device,
                   planar.data_ptr(), out.data_ptr(), planar[0].numel() // 16,
                   *spec.GRAYSCALE_WEIGHTS_INT_RGB, spec.GRAYSCALE_SHIFT)
    return out
