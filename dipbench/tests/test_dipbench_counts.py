"""The yardstick's byte and operation counts."""

import pytest

from dipbench import counts
from dipbench.reference import ops as ref

H, W = 2336, 3504


@pytest.mark.parametrize("col", list(ref.OPS))
def test_logical_bytes_at_the_hrf_size(col):
    # Every op of the matrix maps the image to one of its shape: the
    # image read once and written once, whatever the layout.
    assert counts.op_bytes(H, W, "uint8") == 49_112_064
    assert counts.op_bytes(H, W, "float32") == 196_448_256
    assert col in counts.OPS_PER_ELEMENT


@pytest.mark.parametrize("col", list(ref.OPS))
def test_every_f32_bound_is_the_bytes_at_the_hbm_rate(col):
    bound = counts.bound_s(col, H, W, "float32")
    assert bound == pytest.approx(196_448_256 / 3.35e12)
    assert bound * 1e6 == pytest.approx(58.64, abs=0.01)
