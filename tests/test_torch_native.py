"""The port's native C++ oracle (``dip_benchmark_tpu_torch/native``): equal
to the port's NumPy oracle and to the JAX package's on every column, built
at first use into ``_build/<hash>/`` by any number of processes at once,
never raising for a broken library, and what uint8 ``--verify`` checks
against when it builds."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from dip_benchmark_tpu import oracle as jax_oracle
from dip_benchmark_tpu_torch import cli, native, oracle, oracle_f32
from dip_benchmark_tpu_torch.parallel.session import ShardedBenchmarkSession
from dip_benchmark_tpu_torch.session import BenchmarkSession
from dip_benchmark_tpu_torch.utils.image import save_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture
def built():
    """The library, built; skips only where there is no g++ at all."""
    if shutil.which(native.CXX) is None:
        pytest.skip(f"no {native.CXX}: the native oracle cannot be built")
    assert native.available(), native.build_error()


@pytest.fixture
def fresh_state(monkeypatch):
    """The module as freshly imported: nothing loaded, no error kept."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)


def test_columns_are_the_oracle_columns(built):
    assert list(native.image_ops()) == list(oracle.IMAGE_OPS) == list(
        jax_oracle.IMAGE_OPS)


@pytest.mark.parametrize("fixture", ["small_image", "gradient_image"])
@pytest.mark.parametrize("col", list(oracle.IMAGE_OPS))
def test_native_equals_numpy_and_jax_oracles(col, fixture, built, request):
    image = request.getfixturevalue(fixture)
    got = native.image_ops()[col](image)
    assert got.dtype == np.uint8 and got.shape == image.shape
    np.testing.assert_array_equal(got, oracle.IMAGE_OPS[col](image),
                                  err_msg=col)
    np.testing.assert_array_equal(got, jax_oracle.IMAGE_OPS[col](image),
                                  err_msg=col)


def test_separable_ops_round_between_passes(built, small_image):
    # One pass of the outer-product mask would not round the intermediate.
    from dip_benchmark_tpu_torch import spec
    once = native.convolution(small_image, spec.BLUR_5X5_INT,
                              spec.BLUR_5X5_SHIFT)
    twice = native.image_ops()["Convolution-1x5+5x1"](small_image)
    assert not np.array_equal(once, twice)
    np.testing.assert_array_equal(
        twice, oracle.convolution_5x5_separated(small_image))


@pytest.mark.parametrize("rebuild", ["fails", "repairs"])
def test_corrupt_library_degrades_not_raises(rebuild, tmp_path, monkeypatch,
                                             fresh_state):
    # A corrupt library where the build would put it (an interrupted
    # build): one rebuild, then available() is False or the rebuilt one
    # loads, and nothing raises.
    if rebuild == "repairs" and shutil.which(native.CXX) is None:
        pytest.skip(f"no {native.CXX}")
    monkeypatch.setattr(native, "BUILD_ROOT", str(tmp_path))
    bad = str(tmp_path / "lib.so")
    with open(bad, "wb") as f:
        f.write(b"not an ELF")
    monkeypatch.setattr(native, "library_path", lambda: bad)
    calls = []
    real_build = native._build

    def build(path):
        calls.append(path)
        return ("rebuild disabled for test" if rebuild == "fails"
                else real_build(path))

    monkeypatch.setattr(native, "_build", build)
    if rebuild == "fails":
        assert native.available() is False
        assert "rebuild disabled" in native.build_error()
        with pytest.raises(RuntimeError, match="unavailable"):
            native.copy(np.zeros((5, 5, 3), np.uint8))
        assert native.monotonic_ns() > 0  # the perf_counter fallback
    else:
        assert native.available() is True and native.build_error() is None
        np.testing.assert_array_equal(
            native.inversion(np.zeros((5, 5, 3), np.uint8)),
            np.full((5, 5, 3), 255, np.uint8))
    assert calls == [bad]  # once, whatever came of it


def test_no_compiler_makes_it_unavailable(monkeypatch, fresh_state):
    monkeypatch.setattr(native, "CXX", "/nonexistent/g++")
    assert native.available() is False
    assert "compiler" in native.build_error()


def test_concurrent_builds_all_load(tmp_path):
    # Processes that find no library build it at once into the same
    # directory; each loads a whole one, and no private file is left.
    if shutil.which(native.CXX) is None:
        pytest.skip(f"no {native.CXX}")
    code = ("import sys\n"
            "from dip_benchmark_tpu_torch import native\n"
            "native.BUILD_ROOT = sys.argv[1]\n"
            "ok = native.available()\n"
            "im = native.grayscale(__import__('numpy').full((6, 7, 3), 9,"
            " 'uint8'))\n"
            "print(ok, native.library_path(), int(im[0, 0, 0]),"
            " native.build_error())\n")
    env = {**os.environ, "PYTHONPATH": REPO}
    root = str(tmp_path / "_build")
    procs = [subprocess.Popen([sys.executable, "-c", code, root], cwd=REPO,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=180) for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], outs
    lines = [out.split() for out, _ in outs]
    assert all(ln[0] == "True" and ln[2] == "9" for ln in lines), outs
    path = lines[0][1]
    assert all(ln[1] == path for ln in lines)
    assert path.startswith(root)
    assert os.listdir(os.path.dirname(path)) == [native.LIB_NAME]


def test_monotonic_ns_is_monotonic(built):
    stamps = [native.monotonic_ns() for _ in range(1000)]
    assert stamps[0] > 0 and all(b >= a for a, b in zip(stamps, stamps[1:]))


@pytest.mark.parametrize("bad", [
    np.zeros((8, 8, 4), np.uint8),
    np.zeros((8, 4, 2), np.uint8),
    np.zeros((8, 8), np.uint8),
    np.zeros((8, 8, 3), np.int32),
])
def test_non_rgb_input_raises(bad, built):
    for fn in native.image_ops().values():
        with pytest.raises(ValueError, match="RGB"):
            fn(bad)


def test_import_starts_no_build():
    # A fresh interpreter with no compiler on PATH imports the port and
    # the binding without building anything.
    code = ("import dip_benchmark_tpu_torch.native as n\n"
            "import dip_benchmark_tpu_torch.cli\n"
            "print(n._lib is None, n._build_error is None)\n")
    env = {**os.environ, "PYTHONPATH": REPO, "PATH": "/nonexistent"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["True", "True"]


@pytest.mark.parametrize("session_cls", ["single", "sharded"])
def test_oracle_ops_prefer_native_for_uint8(session_cls, small_image,
                                            monkeypatch, built):
    def make(dtype="uint8"):
        if session_cls == "sharded":
            return ShardedBenchmarkSession(small_image, CPU, n_devices=2,
                                           dtype=dtype)
        return BenchmarkSession(small_image, CPU, dtype=dtype)

    def source(ops):
        return {fn.__module__ for col, fn in ops.items()
                if not col.startswith("Fused-Chain")}

    session = make()
    assert source(session.oracle_ops()) == {native.__name__}
    # A chain row's own oracle still overrides the base.
    col = session.chain_operation(["Inversion", "Convolution-3x3"]).csv_column
    ops = session.oracle_ops()
    assert col.startswith("Fused-Chain") and len(ops) == 14
    assert ops[col] is session._extra_oracles[col]
    assert source(ops) == {native.__name__}
    # float32 keeps the f32 oracle.
    f32 = make("float32").oracle_ops()
    assert f32.keys() == oracle_f32.uint8_verify_ops().keys()
    assert native.__name__ not in source(f32)
    # Without the library, the NumPy oracle.
    monkeypatch.setattr(native, "available", lambda: False)
    assert make().oracle_ops() == oracle.IMAGE_OPS


def test_cli_verify_reaches_native_ops(tmp_path, small_image, monkeypatch,
                                       built, capsys):
    seen = []
    real = native.image_ops

    def counted():
        return {col: (lambda im, col=col, fn=fn: seen.append(col) or fn(im))
                for col, fn in real().items()}

    monkeypatch.setattr(native, "image_ops", counted)
    path = str(tmp_path / "small.png")
    save_image(path, small_image)
    assert cli.main([path, str(tmp_path / "out"), "--rounds", "1",
                     "--backend", "cpu", "--verify", "--pipeline"]) == 0
    assert sorted(seen) == sorted(oracle.IMAGE_OPS)
    assert "FAILED" not in capsys.readouterr().out
