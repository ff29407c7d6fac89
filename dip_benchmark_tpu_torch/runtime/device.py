"""Device gate and banner (the port of ``dip_benchmark_tpu/runtime/device.py``).

``--backend cuda`` needs a CUDA device and fails fast without one, like the
reference backends' startup gates; ``--backend cpu`` is the explicit host
choice, where every op runs its plain PyTorch version.
"""

from __future__ import annotations

import platform

import torch


class DeviceGateError(RuntimeError):
    """No suitable device available."""


def gate_backend(backend: str) -> torch.device:
    """The device for ``backend`` ("cuda" or "cpu"); raises
    DeviceGateError when "cuda" is asked for and none is available."""
    if backend == "cpu":
        return torch.device("cpu")
    if backend != "cuda":
        raise ValueError(f"unknown backend {backend!r} (want cuda|cpu)")
    if not torch.cuda.is_available():
        raise DeviceGateError(
            "No CUDA device available (torch.cuda.is_available() is "
            "False). Pass --backend cpu to run on host.")
    return torch.device("cuda", torch.cuda.current_device())


def describe_device(device: torch.device) -> str:
    """Device banner: name, SM count and compute capability on CUDA."""
    if device.type == "cuda":
        p = torch.cuda.get_device_properties(device)
        return (f"Platform: cuda | Device: {p.name} (id={device.index}) | "
                f"SMs: {p.multi_processor_count} | "
                f"compute capability {p.major}.{p.minor}")
    return f"Platform: cpu | Device: {platform.machine()}"


def synchronize(device: torch.device) -> None:
    """Wait for all work queued on ``device`` (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
