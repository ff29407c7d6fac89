"""An image wider than the JAX package's single-buffer envelope runs
through the port's one-buffer session unchanged: no column strips. On the
CPU the kernels' plain versions run; the card's run is ``chip_smoke.py``
phase [8w]."""

import numpy as np
import pytest
import torch

from dip_benchmark_tpu.utils.image import fit_band
from dip_benchmark_tpu_torch import oracle
from dip_benchmark_tpu_torch.parallel.session import ShardedBenchmarkSession
from dip_benchmark_tpu_torch.session import BenchmarkSession

WIDTH = 52_800  # past 52,732 (uint8) and 33,660 (float32) columns
MAIN_CHAINS = {
    "uint8": ["Convolution-5x5", "Inversion", "Convolution-3x3"],
    "float32": ["Grayscale", "Threshold", "Erosion-3x3-Square",
                "Gaussian-Blur-3x3"],
}
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def wide_image() -> np.ndarray:
    return np.random.default_rng(52_800).integers(0, 256, (8, WIDTH, 3),
                                                  dtype=np.uint8)


def test_width_is_past_the_jax_envelope():
    assert fit_band(WIDTH) == 0
    assert fit_band(WIDTH, itemsize=4) == 0


@pytest.mark.parametrize("shards", [0, 2])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_every_column_equals_the_oracle(dtype, shards, wide_image):
    session = (ShardedBenchmarkSession(wide_image, CPU, n_devices=shards,
                                       dtype=dtype) if shards
               else BenchmarkSession(wide_image, CPU, dtype=dtype))
    ops = [op for op in session.operations(include_pipeline=True)
           if op.prefix]
    ops.append(session.chain_operation(MAIN_CHAINS[dtype]))
    assert len(ops) == 14
    verify = session.oracle_ops()
    for op in ops:
        op.run()
        got = op.fetch()
        assert got.shape == wide_image.shape, op.csv_column
        want = verify[op.csv_column](wide_image)
        if dtype == "uint8":
            np.testing.assert_array_equal(got, want, err_msg=op.csv_column)
            if op.csv_column in oracle.IMAGE_OPS:
                np.testing.assert_array_equal(
                    got, oracle.IMAGE_OPS[op.csv_column](wide_image),
                    err_msg=op.csv_column)
            continue
        want, dontcare = want if isinstance(want, tuple) else (want, False)
        delta = np.abs(got.astype(int) - want.astype(int))
        assert np.where(dontcare, 0, delta).max() <= 1, op.csv_column


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_wide_kernels_on_card_equal_plain(dtype, wide_image):
    # Each kernel of the path, the chain's included, at this width on the
    # card: the whole buffer equal to the plain version's, tolerance 0.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    sessions = [BenchmarkSession(wide_image, dev, dtype=dtype)
                for dev in (torch.device("cuda"), CPU)]
    tables = [[op for op in s.operations(include_pipeline=True) if op.prefix]
              + [s.chain_operation(MAIN_CHAINS[dtype])] for s in sessions]
    for card_op, plain_op in zip(*tables):
        card_op.run()
        plain_op.run()
        torch.testing.assert_close(sessions[0]._sample.cpu(),
                                   sessions[1]._sample, rtol=0, atol=0,
                                   msg=card_op.csv_column)
