"""The port's hand-written CUDA kernels: build, launch and launch counts.

``launch`` is the one place a kernel is started from Python: it passes the
tensors' device pointers and PyTorch's current stream to a C entry point of
the library, raises if the launch was refused, and only then adds one to
the kernel's count in ``LAUNCHES``. A run shows that it went through the
kernels by zeroing the counts (``reset_launches``) and reading them after.
"""

from __future__ import annotations

import torch

from .build import KernelLibraryError, load  # noqa: F401


class KernelLaunchError(RuntimeError):
    """A CUDA kernel launch was refused or failed."""


def check_planar(planar: torch.Tensor, channels: int | None = None,
                 batched: bool = False) -> None:
    """Raise unless ``planar`` is a contiguous uint8 ``(C, Hp, pitch)``
    tensor (or, with ``batched``, also a ``(B, C, Hp, pitch)`` stack)
    whose pitch and base address suit 16-byte vector access."""
    dims = (3, 4) if batched else (3,)
    if planar.dtype != torch.uint8 or planar.dim() not in dims:
        want = " or (B, C, Hp, pitch)" if batched else ""
        raise ValueError(f"expected a (C, Hp, pitch){want} uint8 tensor, "
                         f"got {planar.dtype} {tuple(planar.shape)}")
    if channels is not None and planar.shape[-3] != channels:
        raise ValueError(f"expected {channels} planes, got "
                         f"{planar.shape[-3]}")
    if not planar.is_contiguous():
        raise ValueError("planar tensor must be contiguous")
    if planar.device.type == "cuda" and (
            planar.shape[-1] % 16 or planar.data_ptr() % 16):
        raise ValueError("the CUDA kernels need a pitch and a base address "
                         "that are multiples of 16 bytes")


def on_cpu(planar: torch.Tensor) -> bool:
    """True for a CPU tensor, False for a CUDA one; raise for any other."""
    if planar.device.type == "cpu":
        return True
    if planar.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for a tensor on {planar.device}")


# Kernel name (as in csrc/, with its template arguments) -> launches.
LAUNCHES: dict[str, int] = {}


def reset_launches() -> None:
    LAUNCHES.clear()


def launch(name: str, entry: str, device: torch.device, *args) -> None:
    """Call C entry point ``entry`` with ``args`` and the current stream of
    ``device``; count one launch of ``name`` if it started."""
    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = getattr(lib, entry)(*args, stream)
    if status != 0:
        raise KernelLaunchError(
            f"{name}: {lib.dip_error_string(status).decode()} "
            f"(cudaError {status})")
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1
