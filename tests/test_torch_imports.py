"""The PyTorch port imports without JAX or Triton, builds its kernels or
raises, and never reaches a kernel from a CPU tensor."""

import ast
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from dip_benchmark_tpu_torch import cli
from dip_benchmark_tpu_torch.ops import OPS, kernels
from dip_benchmark_tpu_torch.ops.kernels import build
from dip_benchmark_tpu_torch.utils.image import (make_layout, save_image,
                                                 to_planar_padded)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_neither_jax_nor_triton():
    # A fresh interpreter: this one has JAX loaded by the conftest.
    code = ("import sys\n"
            "import dip_benchmark_tpu_torch, dip_benchmark_tpu_torch.cli\n"
            "import dip_benchmark_tpu_torch.session, dip_benchmark_tpu_torch.ops\n"
            "bad = [m for m in ('jax', 'triton') if m in sys.modules]\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_imports_only_the_port():
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    ours = [m for m in names if m.split(".")[0].startswith("dip_benchmark")]
    assert ours and all(m.split(".")[0] == "dip_benchmark_tpu_torch"
                        for m in ours), ours
    assert not [m for m in names if m.split(".")[0] in ("jax", "triton")]


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_device_or_the_port(where, tmp_path):
    # With no CUDA device here, and alone in a directory without the port,
    # the script exits non-zero and prints no result line.
    cwd = REPO
    if where == "alone":
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env={**env, "CUDA_VISIBLE_DEVICES": ""},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setenv("NVCC", "/nonexistent/nvcc")
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "library_path",
                        lambda: "/nonexistent/libdipkernels.so")
    with pytest.raises(build.KernelLibraryError, match="nvcc"):
        build.load()
    assert build._lib is None


def test_cpu_tensors_launch_no_kernel(small_image):
    planar = to_planar_padded(small_image, make_layout(*small_image.shape[:2]))
    kernels.reset_launches()
    for fn in OPS.values():
        fn(planar)
    assert kernels.LAUNCHES == {}


@pytest.mark.parametrize("col", sorted(OPS))
def test_wrapper_refuses_other_devices(col):
    # Neither CPU nor CUDA: the wrapper raises instead of picking a path.
    planar = torch.empty((3, 9, 16), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="meta"):
        OPS[col](planar)


@pytest.mark.parametrize("bad", [
    torch.zeros((3, 9, 16), dtype=torch.int32),
    torch.zeros((9, 16), dtype=torch.uint8),
    torch.zeros((3, 9, 32), dtype=torch.uint8)[..., ::2],
])
def test_wrapper_checks_its_input(bad):
    with pytest.raises(ValueError):
        OPS["Convolution-5x5"](bad)


def test_cli_cuda_backend_without_device_exits_4(tmp_path, small_image,
                                                 monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(tmp_path / "small.png")
    save_image(path, small_image)
    assert cli.main([path, str(tmp_path / "out"), "--rounds", "1",
                     "--backend", "cuda"]) == 4


def test_cli_refuses_tiny_image(tmp_path):
    path = str(tmp_path / "tiny.png")
    save_image(path, np.zeros((4, 9, 3), np.uint8))
    assert cli.main([path, str(tmp_path / "out"), "--rounds", "1",
                     "--backend", "cpu"]) == 2
