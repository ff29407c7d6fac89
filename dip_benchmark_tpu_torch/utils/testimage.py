"""The benchmark image: the shared NumPy-only resolver, re-exported.

``resolve_image()`` returns ``(image, label)``: the image at ``path`` or
``$DIP_TPU_IMAGE`` when given, else the reference fundus photograph when
it is present, else a deterministic synthetic fundus at 3504x2336.
Nothing is downloaded.
"""

from dip_benchmark_tpu.utils.testimage import resolve_image  # noqa: F401
