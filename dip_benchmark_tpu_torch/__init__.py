"""dip_benchmark_tpu_torch: the DIP benchmark on PyTorch and hand-written CUDA.

The port of ``dip_benchmark_tpu`` (JAX, XLA and Pallas on a TPU) to an
NVIDIA Hopper GPU. It runs the uint8 14-op matrix through CUDA kernels
written for ``sm_90a`` (``ops/kernels/csrc``), bit-exact against the JAX
package and its oracle. It imports ``torch`` and never ``jax``: the shared
NumPy-only layer (``spec``, ``oracle``, ``harness``, ``native``, image I/O,
timing and reporting) is imported from the JAX package, not copied, and
re-exported where a user of the port needs it: ``spec`` here, image I/O
from ``utils.image``, the test image from ``utils.testimage`` and the
oracle from ``BenchmarkSession.oracle_ops``.
"""

from dip_benchmark_tpu import spec  # noqa: F401

__version__ = "0.1.0"
