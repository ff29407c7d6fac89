"""The PyTorch port imports without JAX, the JAX package or Triton, builds
its kernels or raises, and never reaches a kernel from a CPU tensor."""

import ast
import os
import py_compile
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from dip_benchmark_tpu_torch import cli
from dip_benchmark_tpu_torch.ops import OPS, OPS_F32, kernels
from dip_benchmark_tpu_torch.ops.kernels import build
from dip_benchmark_tpu_torch.parallel import make_mesh
from dip_benchmark_tpu_torch.runtime import DeviceGateError
from dip_benchmark_tpu_torch.utils.image import (make_layout, save_image,
                                                 to_planar_padded,
                                                 to_planar_padded_f32)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "dip_benchmark_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "dip_benchmark_tpu", "triton")


def loaded_after(imports: str) -> list[str]:
    """The FORBIDDEN modules in a fresh interpreter's sys.modules after
    ``imports`` (this interpreter has JAX loaded by the conftest)."""
    code = (f"import sys\n{imports}\n"
            f"print([m for m in {FORBIDDEN!r} if m in sys.modules])\n")
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return ast.literal_eval(proc.stdout.strip().splitlines()[-1])


def imported_modules(path: str) -> list[str]:
    """Absolute module names a source file imports (relative imports
    stay inside its package and are left out)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module and not n.level]
    return names


def test_port_imports_neither_jax_nor_triton():
    assert loaded_after(
        "import dip_benchmark_tpu_torch, dip_benchmark_tpu_torch.cli\n"
        "import dip_benchmark_tpu_torch.session, dip_benchmark_tpu_torch.ops\n"
        "import dip_benchmark_tpu_torch.harness\n"
        "import dip_benchmark_tpu_torch.oracle\n"
        "import dip_benchmark_tpu_torch.oracle_f32\n"
        "import dip_benchmark_tpu_torch.ops.f32\n"
        "import dip_benchmark_tpu_torch.models.batch\n"
        "import dip_benchmark_tpu_torch.models.pipeline\n"
        "import dip_benchmark_tpu_torch.ops.library\n"
        "import dip_benchmark_tpu_torch.ops.library_f32\n"
        "import dip_benchmark_tpu_torch.runtime.aot\n"
        "import dip_benchmark_tpu_torch.runtime.exec_timing\n"
        "import dip_benchmark_tpu_torch.parallel\n"
        "import dip_benchmark_tpu_torch.parallel.halo\n"
        "import dip_benchmark_tpu_torch.parallel.ops\n"
        "import dip_benchmark_tpu_torch.parallel.kernel_ops\n"
        "import dip_benchmark_tpu_torch.parallel.session\n"
        "import dip_benchmark_tpu_torch.native\n"
        "import dip_benchmark_tpu_torch.utils.plots\n"
        "import dip_benchmark_tpu_torch.utils.testimage") == []


def test_port_imports_without_matplotlib():
    # matplotlib made unimportable: the package, the reporting module and
    # its CSV reader still load; only rendering needs it.
    code = ("import sys\n"
            "sys.modules['matplotlib'] = None\n"
            "import dip_benchmark_tpu_torch.cli\n"
            "import dip_benchmark_tpu_torch.native\n"
            "from dip_benchmark_tpu_torch.utils import plots, testimage\n"
            "try:\n"
            "    import matplotlib\n"
            "except ImportError:\n"
            "    print('no matplotlib', plots.main.__name__)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env={**os.environ, "PYTHONPATH": REPO},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["no", "matplotlib", "main"]


def test_chip_smoke_compiles(tmp_path):
    py_compile.compile(os.path.join(REPO, "chip_smoke.py"),
                       cfile=str(tmp_path / "chip_smoke.pyc"), doraise=True)


def test_no_port_file_imports_the_jax_package():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PORT) for f in fs
             if f.endswith(".py")]
    assert len(files) >= 20
    assert {"halo.py", "ops.py", "kernel_ops.py", "session.py"} <= {
        os.path.basename(f) for f in files
        if os.path.basename(os.path.dirname(f)) == "parallel"}
    assert {os.path.join("native", "__init__.py"),
            os.path.join("utils", "plots.py")} <= {
        os.path.relpath(f, PORT) for f in files}
    bad = {os.path.relpath(f, REPO): m for f in files
           for m in imported_modules(f) if m.split(".")[0] in FORBIDDEN}
    assert not bad, bad


def test_chip_smoke_imports_only_the_port():
    names = imported_modules(os.path.join(REPO, "chip_smoke.py"))
    ours = [m for m in names if m.split(".")[0].startswith("dip_benchmark")]
    assert ours and all(m.split(".")[0] == "dip_benchmark_tpu_torch"
                        for m in ours), ours
    assert not [m for m in names if m.split(".")[0] in FORBIDDEN]
    # And what it imports, imported: the port loads none of them either.
    assert loaded_after("import chip_smoke") == []


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


def fake_nvcc(tmp_path, fail_on: str = "") -> str:
    """A stand-in compiler that logs its arguments and writes its -o file,
    or fails on a source whose name ends in ``fail_on``."""
    script = tmp_path / "nvcc"
    script.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "args = sys.argv[1:]\n"
        f"with open({str(tmp_path / 'calls.txt')!r}, 'a') as f:\n"
        "    f.write(' '.join(args) + '\\n')\n"
        f"if {fail_on!r} and any(a.endswith({fail_on!r}) for a in args):\n"
        "    print('error: broken source')\n"
        "    sys.exit(1)\n"
        "open(args[args.index('-o') + 1], 'w').write('x')\n")
    script.chmod(0o755)
    return str(script)


def test_build_compiles_each_source_then_links(tmp_path, monkeypatch):
    monkeypatch.setenv("NVCC", fake_nvcc(tmp_path))
    monkeypatch.setattr(build, "BUILD_ROOT", str(tmp_path / "_build"))
    path = build.build()
    assert path == build.library_path() and os.path.exists(path)
    calls = (tmp_path / "calls.txt").read_text().splitlines()
    compiles, link = calls[:-1], calls[-1]
    assert sorted(c.split()[-1].rsplit("/", 1)[1] for c in compiles) == \
        sorted(build.SOURCES)
    assert all(" -c " in c and "sm_90a" in c for c in compiles)
    assert "-shared" in link.split() and link.count(".o") == len(build.SOURCES)
    assert build.build() == path  # built once: the second call is a lookup
    assert len((tmp_path / "calls.txt").read_text().splitlines()) == len(
        build.SOURCES) + 1
    assert os.listdir(os.path.dirname(path)) == [build.LIB_NAME]


def test_build_failure_raises_with_the_compiler_output(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("NVCC", fake_nvcc(tmp_path, fail_on="window.cu"))
    monkeypatch.setattr(build, "BUILD_ROOT", str(tmp_path / "_build"))
    with pytest.raises(build.KernelLibraryError, match="broken source"):
        build.build()
    assert not os.path.exists(build.library_path())
    assert "-shared" not in (tmp_path / "calls.txt").read_text()


def test_cpu_tensors_launch_no_kernel(small_image):
    layout = make_layout(*small_image.shape[:2])
    planar = to_planar_padded(small_image, layout)
    kernels.reset_launches()
    for fn in OPS.values():
        fn(planar)
    planar_f32 = to_planar_padded_f32(small_image, layout)
    for fn in OPS_F32.values():
        fn(planar_f32)
    OPS_F32["Fused-Pipeline"](torch.stack([planar_f32, planar_f32]))
    assert kernels.LAUNCHES == {}


@pytest.mark.parametrize("col", sorted(OPS))
def test_wrapper_refuses_other_devices(col):
    # Neither CPU nor CUDA: the wrapper raises instead of picking a path.
    planar = torch.empty((3, 9, 16), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="meta"):
        OPS[col](planar)


@pytest.mark.parametrize("col", sorted(OPS_F32))
def test_f32_wrapper_refuses_other_devices(col):
    planar = torch.empty((3, 9, 16), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        OPS_F32[col](planar)


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


@pytest.mark.parametrize("count,n_space,n_data", [(1, 4, 1), (1, 2, 2),
                                                  (2, 3, 1), (4, 2, 3)])
def test_cuda_mesh_never_places_a_shard_on_the_cpu(count, n_space, n_data,
                                                   monkeypatch, capsys):
    # Shards are dealt round-robin over the CUDA devices, however few.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    mesh = make_mesh(n_space, n_data, backend="cuda")
    assert (mesh.n_space, mesh.n_data) == (n_space, n_data)
    assert [d for d in mesh.flat] == [torch.device("cuda", i % count)
                                      for i in range(n_space * n_data)]
    assert ("NOTE:" in capsys.readouterr().err) == (count < n_space * n_data)
    assert make_mesh(n_space, n_data, backend="cpu").distinct == (
        torch.device("cpu"),)


def test_cuda_mesh_without_a_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceGateError, match="No CUDA device"):
        make_mesh(2, backend="cuda")


def test_sharded_cli_on_cuda_without_a_device_exits_4(tmp_path, small_image,
                                                     monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(tmp_path / "small.png")
    save_image(path, small_image)
    assert cli.main([path, str(tmp_path / "out"), "--rounds", "1",
                     "--shards", "2"]) == 4


def test_cli_refuses_tiny_image(tmp_path):
    path = str(tmp_path / "tiny.png")
    save_image(path, np.zeros((4, 9, 3), np.uint8))
    assert cli.main([path, str(tmp_path / "out"), "--rounds", "1",
                     "--backend", "cpu"]) == 2
