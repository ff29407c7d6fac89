"""dip_benchmark_tpu_torch: the DIP benchmark on PyTorch and hand-written CUDA.

The port of ``dip_benchmark_tpu`` (JAX, XLA and Pallas on a TPU) to an
NVIDIA Hopper GPU. It runs the uint8 14-op matrix, the fused pipeline and
the batch tool through CUDA kernels written for ``sm_90a``
(``ops/kernels/csrc``), bit-exact against the JAX package and its oracle.
It imports ``torch`` and never ``jax``, and nothing of the JAX package:
its NumPy-only layer (``spec``, ``oracle``, ``harness``, image I/O,
``utils/testimage``, ``utils/timing``, ``utils/reporting``) is the port's
own copy, under the JAX package's module names.
"""

from . import spec  # noqa: F401

__version__ = "0.1.0"
