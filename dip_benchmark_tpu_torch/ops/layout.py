"""The layout of an image stack, both ways: the bake, HWC uint8 ->
planar, mirror-padded, and the crop, planar -> HWC uint8.

``bake_stack`` launches the CUDA kernel ``bake_u8`` (``kernels/csrc/
layout.cu``) for a stack on the card; ``bake_stack_plain`` is the plain
PyTorch version of the same function, which the wrapper takes only for a
stack on the CPU. Both give ``utils/image.stack_planar_padded``'s stack,
byte for byte: rows by ``mirror_rows``, every column, slack included, by
``mirror_cols``. ``crop_stack`` and ``crop_stack_plain`` are the inverse
pair, ``crop_u8`` in the same source: a planar stack's valid region as a
``(B, H, W, 3)`` stack, byte for byte ``utils/image.from_planar_padded``'s.
"""

from __future__ import annotations

import torch

from ..runtime import tracing
from ..utils.image import (PlanarLayout, _valid_region, mirror_cols,
                           mirror_rows)
from . import kernels


def _check_stack(stack: torch.Tensor, layout: PlanarLayout) -> None:
    if stack.dtype != torch.uint8 or stack.dim() != 4:
        raise ValueError(f"expected a (B, H, W, 3) uint8 stack, got "
                         f"{stack.dtype} {tuple(stack.shape)}")
    if stack.shape[3] != 3 or layout.channels != 3:
        raise ValueError(f"expected 3 channels, got {stack.shape[3]} for "
                         f"{layout}")
    if not stack.is_contiguous():
        raise ValueError("the stack must be contiguous")
    if len(stack) == 0 or tuple(stack.shape[1:3]) != (layout.height,
                                                      layout.width):
        raise ValueError(f"stack {tuple(stack.shape)} does not fit {layout}")


def bake_stack_plain(stack: torch.Tensor,
                     layout: PlanarLayout) -> torch.Tensor:
    """``(B, H, W, 3)`` uint8 -> ``(B, 3, Hp, pitch)`` uint8, as
    ``stack_planar_padded`` bakes it."""
    ys = torch.from_numpy(mirror_rows(layout)).to(stack.device)
    xs = torch.from_numpy(mirror_cols(layout)).to(stack.device)
    planar = stack.permute(0, 3, 1, 2)
    return planar.index_select(2, ys).index_select(3, xs).contiguous()


def bake_stack(stack: torch.Tensor, layout: PlanarLayout) -> torch.Tensor:
    """The ``(B, 3, Hp, pitch)`` planar stack of a contiguous ``(B, H, W,
    3)`` uint8 stack on ``layout``, on the stack's device; a bake on the
    card adds the stack's images to the port's ``card_bakes`` counter."""
    _check_stack(stack, layout)
    if kernels.on_cpu(stack):
        return bake_stack_plain(stack, layout)
    b = len(stack)
    with tracing.span("alloc"):
        out = torch.empty((b,) + layout.shape, dtype=torch.uint8,
                          device=stack.device)
    kernels.launch("bake_u8", "dip_bake_u8", stack.device, stack.data_ptr(),
                   out.data_ptr(), b, layout.height, layout.width, layout.pad,
                   layout.pitch)
    tracing.count("card_bakes", b)
    return out


def _check_planar_stack(planar: torch.Tensor, layout: PlanarLayout) -> None:
    if planar.dim() != 4 or layout.channels != 3:
        raise ValueError(f"expected a (B, 3, Hp, pitch) stack on a 3-channel "
                         f"layout, got {tuple(planar.shape)} for {layout}")
    kernels.check_planar(planar, channels=3, batched=True)
    if len(planar) == 0 or tuple(planar.shape[1:]) != layout.shape:
        raise ValueError(f"planar stack {tuple(planar.shape)} does not fit "
                         f"{layout}")


def crop_stack_plain(planar: torch.Tensor,
                     layout: PlanarLayout) -> torch.Tensor:
    """``(B, 3, Hp, pitch)`` uint8 -> ``(B, H, W, 3)`` uint8, as
    ``from_planar_padded`` crops it."""
    return _valid_region(planar, layout).permute(0, 2, 3, 1).contiguous()


def crop_stack(planar: torch.Tensor, layout: PlanarLayout) -> torch.Tensor:
    """The contiguous ``(B, H, W, 3)`` stack of the valid region of a
    ``(B, 3, Hp, pitch)`` uint8 planar stack on ``layout``, on the stack's
    device; a crop on the card adds the stack's images to the port's
    ``card_crops`` counter."""
    _check_planar_stack(planar, layout)
    if kernels.on_cpu(planar):
        return crop_stack_plain(planar, layout)
    b = len(planar)
    with tracing.span("alloc"):
        out = torch.empty((b, layout.height, layout.width, 3),
                          dtype=torch.uint8, device=planar.device)
    kernels.launch("crop_u8", "dip_crop_u8", planar.device, planar.data_ptr(),
                   out.data_ptr(), b, layout.height, layout.width, layout.pad,
                   layout.pitch)
    tracing.count("card_crops", b)
    return out
