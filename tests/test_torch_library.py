"""The port's library-call path (ops/library.py, ops/library_f32.py, the
session's path="library" and the batch tool's single ops) against the JAX
package's XLA path and the oracles, on the CPU. uint8: tolerance 0, alone
and on a (B, H, W, 3) stack. float32: within 1e-6 of the JAX ops, whose
sums run in another order (``F.conv2d`` against the slice sums), and
within 1 level of the verify oracle outside its don't-care mask once
quantized, the CLI's float32 contract."""

import jax
import numpy as np
import pytest
import torch

from dip_benchmark_tpu.models import batch as jax_batch
from dip_benchmark_tpu.ops import xla, xla_f32
from dip_benchmark_tpu_torch import oracle, oracle_f32
from dip_benchmark_tpu_torch.models import batch
from dip_benchmark_tpu_torch.ops import kernels, library, library_f32
from dip_benchmark_tpu_torch.session import BenchmarkSession
from dip_benchmark_tpu_torch.utils.image import load_image, save_image

COLS = sorted(library.IMAGE_OPS)
SHAPES = ((37, 53, 3), (5, 5, 3))
F32_ATOL = 1e-6


def image(shape, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def test_library_registers_the_jax_columns():
    assert len(COLS) == 13
    assert COLS == sorted(xla.IMAGE_OPS) == sorted(oracle.IMAGE_OPS)
    assert sorted(library_f32.IMAGE_OPS_F32) == sorted(
        xla_f32.IMAGE_OPS_F32) == COLS


@pytest.mark.parametrize("col", COLS)
@pytest.mark.parametrize("shape", SHAPES)
def test_uint8_op_equals_jax_and_oracle(col, shape):
    img = image(shape, seed=1)
    got = library.IMAGE_OPS[col](torch.from_numpy(img)).numpy()
    assert got.dtype == np.uint8 and got.shape == img.shape
    np.testing.assert_array_equal(got, oracle.IMAGE_OPS[col](img))
    np.testing.assert_array_equal(
        got, np.asarray(jax.jit(xla.IMAGE_OPS[col])(img)))


@pytest.mark.parametrize("col", COLS)
def test_uint8_op_on_a_stack_equals_jax_vmap(col):
    stack = image((3, 19, 23, 3), seed=2)
    got = library.IMAGE_OPS[col](torch.from_numpy(stack)).numpy()
    assert got.shape == stack.shape
    np.testing.assert_array_equal(
        got, np.asarray(jax.jit(jax.vmap(xla.IMAGE_OPS[col]))(stack)))
    for b in range(3):
        np.testing.assert_array_equal(got[b], oracle.IMAGE_OPS[col](stack[b]))


def test_mirror_pad_is_the_sycl_mirror():
    x = torch.arange(5, dtype=torch.uint8).reshape(1, 5, 1, 1).expand(
        2, 5, 4, 3)
    padded = library.mirror_pad(x, 2, 0)[0, :, 0, 0].tolist()
    assert padded == [2, 1, 0, 1, 2, 3, 4, 4, 3]  # low: -i, high: 2n-i-1
    chw = torch.arange(5.0).reshape(1, 1, 5)
    assert library_f32.mirror_pad_chw(chw, 0, 2)[0, 0].tolist() == [
        2, 1, 0, 1, 2, 3, 4, 4, 3]


@pytest.mark.parametrize("col", COLS)
@pytest.mark.parametrize("shape", SHAPES)
def test_float32_op_is_near_jax_and_the_oracle(col, shape):
    img = image(shape, seed=3)
    x = np.ascontiguousarray(oracle_f32.from_uint8_hwc(img))
    got = library_f32.IMAGE_OPS_F32[col](torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == x.shape
    want = np.asarray(jax.jit(xla_f32.IMAGE_OPS_F32[col])(x))
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
    expected = oracle_f32.uint8_verify_ops()[col](img)
    dontcare = None
    if isinstance(expected, tuple):
        expected, dontcare = expected
    delta = np.abs(oracle_f32.to_uint8_hwc(got).astype(np.int32)
                   - expected.astype(np.int32))
    if dontcare is not None:
        delta = np.where(dontcare, 0, delta)
    assert delta.max() <= 1, col


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_library_session_turns_tf32_off(dtype, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    BenchmarkSession(image((9, 11, 3)), torch.device("cpu"), dtype=dtype,
                     path="library")
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_library_session_runs_on_the_unpadded_image(dtype):
    img = image((12, 17, 3), seed=4)
    session = BenchmarkSession(img, torch.device("cpu"), dtype=dtype,
                               path="library")
    src = session._device_input()
    assert tuple(src.shape) == ((12, 17, 3) if dtype == "uint8"
                                else (3, 12, 17))
    assert not hasattr(session, "planar_dev")
    ops = session.operations(include_pipeline=True)
    oracle_ops = session.oracle_ops()
    for op in ops:
        if not op.prefix:
            continue
        op.run()
        got = op.fetch()
        expected = oracle_ops[op.csv_column](img)
        if isinstance(expected, tuple):
            expected, dontcare = expected
            got = np.where(dontcare, expected, got)
        delta = np.abs(got.astype(np.int32) - expected.astype(np.int32))
        assert delta.max() <= session.verify_atol, op.csv_column


def test_library_session_refuses_a_fused_chain():
    session = BenchmarkSession(image((9, 11, 3)), torch.device("cpu"),
                               path="library")
    with pytest.raises(ValueError, match="fused chains need --path kernel"):
        session.chain_operation(["Inversion", "Copy"])


def test_session_refuses_an_unknown_path():
    with pytest.raises(ValueError, match="kernel|library"):
        BenchmarkSession(image((9, 11, 3)), torch.device("cpu"), path="xla")


@pytest.mark.parametrize("col", [c for c in COLS if c != "Fused-Pipeline"])
def test_batch_single_op_equals_jax_process_batch(col):
    stack = image((3, 16, 21, 3), seed=5)
    kernels.reset_launches()
    got = batch.process_batch(stack, col, device="cpu")
    assert kernels.LAUNCHES == {}
    np.testing.assert_array_equal(got, jax_batch.process_batch(stack, col))


def test_batch_tool_op_equals_jax_over_a_directory(tmp_path):
    stack = image((3, 16, 21, 3), seed=6)
    other = image((9, 30, 3), seed=7)
    (tmp_path / "in").mkdir()
    named = {f"img{i}.png": im for i, im in enumerate(stack)}
    named["other.png"] = other
    for name, im in named.items():
        save_image(str(tmp_path / "in" / name), im)
    assert batch.main([str(tmp_path / "in"), str(tmp_path / "out"), "--op",
                       "Convolution-5x5", "--backend", "cpu"]) == 0
    for name, im in named.items():
        got = load_image(str(tmp_path / "out" / name))
        np.testing.assert_array_equal(got, jax_batch.process_batch(
            im[None], "Convolution-5x5")[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_library_path_launches_no_kernel_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    img = image((37, 53, 3), seed=8)
    session = BenchmarkSession(img, torch.device("cuda"), dtype=dtype,
                               path="library")
    kernels.reset_launches()
    for op in session.operations(include_pipeline=True):
        op.run()
    assert kernels.LAUNCHES == {}
    ops = (library.IMAGE_OPS if dtype == "uint8"
           else library_f32.IMAGE_OPS_F32)
    src = session._device_input()
    for col, fn in ops.items():
        got = fn(src).cpu()
        want = fn(src.cpu())
        if dtype == "uint8":
            assert torch.equal(got, want), col
        else:
            assert (got - want).abs().max() <= F32_ATOL, col
