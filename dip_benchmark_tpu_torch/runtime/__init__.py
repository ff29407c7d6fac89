from .device import (  # noqa: F401
    DeviceGateError,
    describe_device,
    gate_backend,
    synchronize,
)
