"""Row-block streaming in the float32 data model: the port's
``models/wide.apply_streaming(..., dtype="float32")`` against the JAX
package's, which runs Pallas in interpret mode on the CPU with strips one
lane wide, as ``tests/test_torch_streaming.py`` runs the uint8 model.
Tolerance ``atol=3e-7, rtol=0`` on [0, 1] values, as in
``tests/test_torch_f32.py``: XLA may contract a multiply-add into an FMA
(2 ulp); the port's plain versions round each operation once. The output
is the ``(C, H, W)`` float32 crop, unquantised, in both.
"""

import numpy as np
import pytest
import torch

from dip_benchmark_tpu.models import wide as jax_wide
from dip_benchmark_tpu.utils.image import LANE
from dip_benchmark_tpu_torch.models import wide

CPU = torch.device("cpu")
ATOL = 3e-7  # tests/test_torch_f32.py


@pytest.mark.parametrize("col", wide.WIDE_COLS)
def test_float32_equals_jax_apply_streaming(col):
    img = np.random.default_rng(13).integers(0, 256, (40, 200, 3), np.uint8)
    got = wide.apply_streaming(img, col, block_rows=16, dtype="float32",
                               device=CPU)
    want = jax_wide.apply_streaming(img, col, block_rows=16,
                                    strip_width=LANE, dtype="float32")
    assert got.dtype == np.float32 and got.shape == (3, 40, 200)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_float32_short_remainder_equals_jax():
    # tests/test_wide.py: a 2-row remainder folds into the last block.
    img = np.random.default_rng(47).integers(0, 256, (34, 200, 3), np.uint8)
    got = wide.apply_streaming(img, "Erosion-3x3-Square", block_rows=16,
                               dtype="float32", device=CPU)
    want = jax_wide.apply_streaming(img, "Erosion-3x3-Square",
                                    block_rows=16, strip_width=LANE,
                                    dtype="float32")
    np.testing.assert_array_equal(got, want)  # a min: exact in any order
