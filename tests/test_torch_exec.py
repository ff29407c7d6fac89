"""Execution timing (runtime/exec_timing.py), the session's chained and
execution tables, warm start (runtime/aot.py) and the CLI's new flags,
against the JAX package on the CPU. The CUDA graph code runs only on the
card: its tests are marked ``cuda`` and skip here."""

import json
import os

import numpy as np
import pytest
import torch

from dip_benchmark_tpu import cli as jax_cli
from dip_benchmark_tpu.session import BenchmarkSession as JaxSession
from dip_benchmark_tpu_torch import cli
from dip_benchmark_tpu_torch.harness import Operation
from dip_benchmark_tpu_torch.ops import OPS, PLAIN, library
from dip_benchmark_tpu_torch.runtime import aot, exec_timing
from dip_benchmark_tpu_torch.session import BenchmarkSession
from dip_benchmark_tpu_torch.utils.image import save_image

CPU = torch.device("cpu")
CHAIN = ["Convolution-3x3", "Inversion"]


def image(shape=(13, 17, 3), seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


# -- the slope fit -------------------------------------------------------

@pytest.mark.parametrize("b", [2.5e-5, 3e-7, -4e-6])
def test_fit_recovers_the_slope_and_brackets_it(b):
    rng = np.random.default_rng(1)
    a, ks = 1.2e-5, (10, 40, 160)
    noise = 0.01 * abs(b) * 160
    times = [[a + b * k + rng.normal(0, noise) for k in ks]
             for _ in range(7)]
    t = exec_timing.fit_times(ks, times, "host")
    assert t.per_app_s == pytest.approx(b, rel=0.05)
    assert t.fixed_s == pytest.approx(a, abs=5 * noise)
    assert t.slope_min_s <= t.per_app_s <= t.slope_max_s
    assert t.slope_min_s < b < t.slope_max_s
    assert 0 < t.stderr_s < 0.05 * abs(b)
    assert (t.ks, t.samples, t.where) == (ks, 7, "host")
    # Never clamped: a negative slope is reported as it is, and marked.
    assert t.mark == ("NEGATIVE" if b < 0 else "")


def test_fit_marks_a_spread_that_reaches_zero():
    ks = (10, 40, 160)
    times = [[1.0 + 1e-9 * k for k in ks], [1.0 - 1e-9 * k for k in ks],
             [1.0 + 2e-9 * k for k in ks]]
    t = exec_timing.fit_times(ks, times, "host")
    assert t.per_app_s > 0 and t.slope_min_s < 0 and t.mark == "UNRESOLVED"


def test_fit_line_is_exact_on_a_line():
    a, b, se = exec_timing.fit_line([(1, 3.0), (2, 5.0), (4, 9.0)])
    assert (a, b) == pytest.approx((1.0, 2.0)) and se == pytest.approx(0)


@pytest.mark.parametrize("points", [[(1, 1.0), (2, 2.0)],
                                    [(3, 1.0), (3, 2.0), (3, 3.0)]])
def test_fit_line_needs_three_points_and_two_k(points):
    with pytest.raises(ValueError, match="three points"):
        exec_timing.fit_line(points)


def test_execution_time_on_the_cpu_counts_applications():
    calls = []

    def op(x):
        calls.append(1)
        return x + 1
    t = exec_timing.execution_time("add", op, torch.zeros(3), ks=(1, 2, 4),
                                   samples=2)
    assert len(calls) == 1 + 2 * (1 + 2 + 4)  # one warm call, then the runs
    assert t.where == "host" and t.ks == (1, 2, 4) and t.samples == 2


def test_chain_direct_applies_k_times():
    assert exec_timing.chain_direct(lambda x: 2 * x, torch.ones(2),
                                    5).tolist() == [32.0, 32.0]


# -- the session ----------------------------------------------------------

def jax_cpu():
    import jax
    return jax.devices("cpu")[0]


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_execution_table_has_the_jax_columns(dtype):
    img = image()
    theirs = [col for col, _ in JaxSession(
        img, path="xla", device=jax_cpu(), dtype=dtype).execution_table(
            include_pipeline=True, k1=1, k2=2, samples=1)]
    for path in ("kernel", "library"):
        session = BenchmarkSession(img, CPU, dtype=dtype, path=path)
        want = list(theirs)
        if path == "kernel":
            session.chain_operation(CHAIN)
            want.append("Fused-Chain")
        rows = session.execution_table(include_pipeline=True, ks=(1, 2, 3),
                                       samples=1)
        assert [col for col, _ in rows] == want
        assert all(t.where == "host" and t.ks == (1, 2, 3)
                   for _, t in rows)


@pytest.mark.parametrize("path", ["kernel", "library"])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_a_chained_round_is_k_plain_applications(path, dtype):
    img = image(seed=2)
    session = BenchmarkSession(img, CPU, dtype=dtype, path=path)
    table = session.chained_operations(3, include_pipeline=True)
    src = session._device_input()
    cols = [op.csv_column for op in table]
    assert cols == [c for c in library.IMAGE_OPS]
    for op in table:
        assert op.time_scale == 3 and op.prefix == "" and not op.downloads
        op.run()
        want = src
        for _ in range(3):
            want = session._ops[op.csv_column](want)
        assert torch.equal(session._sample, want), op.csv_column
        if path == "kernel" and dtype == "uint8":
            plain = src
            for _ in range(3):
                plain = PLAIN[op.csv_column](plain)
            assert torch.equal(session._sample, plain), op.csv_column


def test_chained_refuses_an_op_that_changes_the_shape():
    session = BenchmarkSession(image(), CPU)
    session._ops = {**OPS, "Copy": lambda p: p[:, 1:]}
    with pytest.raises(ValueError, match=r"shape-preserving.*'Copy'"):
        session.chained_operations(2)
    with pytest.raises(ValueError, match="shape-preserving"):
        session.execution_table(ks=(1, 2, 3), samples=1)


def test_warm_runs_every_row_but_the_download_once():
    log = []
    table = [Operation(f"d{i}", "", col, lambda c=col: log.append(c),
                       lambda: None, downloads=col == "Download")
             for i, col in enumerate(["Upload", "Download", "Copy"])]
    assert aot.warm(table) == 2 and log == ["Upload", "Copy"]


# -- the CLI --------------------------------------------------------------

CLI_CASES = {
    "exec-chained": (["--exec", "--chained", "2"], 2),
    "fuse-chained": (["--fuse", "Inversion,Copy", "--chained", "2"], 2),
    "chained-0": (["--chained", "0"], 2),
    "chained-verify": (["--chained", "2", "--verify"], 2),
    "library-fuse": (["--path", "library", "--fuse", "Inversion,Copy"], 2),
    "library-verify": (["--path", "library", "--verify", "--pipeline"], 0),
    "warm": (["--warm", "--path", "library", "--pipeline"], 0),
    "profile": (["--profile", "PROFILE", "--path", "library"], 0),
}
JAX_PATH = {"kernel": "pallas", "library": "xla"}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_exits_like_the_jax_cli(case, tmp_path, capsys):
    args, code = CLI_CASES[case]
    path = str(tmp_path / "img.png")
    save_image(path, image((11, 14, 3), seed=3))
    codes = {}
    for name, main, paths in (("port", cli.main, {}),
                              ("jax", jax_cli.main, JAX_PATH)):
        prof = tmp_path / f"prof-{name}"
        argv = [paths.get(a, a) for a in args]
        argv = [str(prof) if a == "PROFILE" else a for a in argv]
        codes[name] = main([path, str(tmp_path / f"out-{name}"), "--rounds",
                            "1", "--warmup", "0", "--backend", "cpu",
                            *argv])
        if case == "profile":
            assert any(files for _, _, files in os.walk(prof)), name
    capsys.readouterr()
    assert codes == {"port": code, "jax": code}


def test_cli_profile_writes_a_chrome_trace(tmp_path, capsys):
    path = str(tmp_path / "img.png")
    save_image(path, image((9, 12, 3), seed=4))
    assert cli.main([path, str(tmp_path / "out"), "--rounds", "2",
                     "--backend", "cpu", "--pipeline", "--profile",
                     str(tmp_path / "prof")]) == 0
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())[
        "traceEvents"]
    names = [e.get("name") for e in events if e.get("ph") == "X"]
    # The port's spans are in it, one op and one sync a round of each of
    # the 13 device rows (warm-up included): the host share splits by
    # them. The Python calls are not.
    assert names.count("dip.op") == names.count("dip.sync") >= 26
    assert not any(e.get("cat") == "python_function" for e in events)
    capsys.readouterr()


def test_cli_exec_prints_every_row_last(tmp_path, capsys):
    path = str(tmp_path / "img.png")
    save_image(path, image((9, 12, 3), seed=5))
    assert cli.main([path, str(tmp_path / "out"), "--rounds", "1",
                     "--backend", "cpu", "--pipeline", "--warm", "--exec",
                     "--fuse", ",".join(CHAIN)]) == 0
    lines = capsys.readouterr().out.splitlines()
    head = lines.index(next(ln for ln in lines if "execution time" in ln))
    rows = lines[head + 1:]
    assert [r.split("|")[1].strip() for r in rows] == list(
        library.IMAGE_OPS) + ["Fused-Chain"]
    for r in rows:
        cells = [c.strip() for c in r.split("|")[1:-1]]
        assert cells[1].endswith("s") and float(cells[1][:-1]) == float(
            cells[1][:-1])
        assert cells[-1] in ("host", "NEGATIVE", "UNRESOLVED")


@pytest.mark.parametrize("path,tool", [("kernel", "CPU-torch"),
                                       ("library", "CPU-torch-library")])
def test_cli_csv_tool_differs_by_path(path, tool, tmp_path, capsys):
    img = str(tmp_path / "img.png")
    save_image(img, image((9, 12, 3), seed=6))
    csv = tmp_path / "r.csv"
    assert cli.main([img, str(tmp_path / "out"), "--rounds", "1",
                     "--backend", "cpu", "--path", path, "--csv",
                     str(csv)]) == 0
    assert csv.read_text().splitlines()[1].startswith(tool + ",")
    assert cli.default_tool(torch.device("cuda", 0), path) == (
        "H100-cuda" if path == "kernel" else "H100-torch")
    capsys.readouterr()


def test_cli_without_a_card_exits_4(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = str(tmp_path / "img.png")
    save_image(img, image((9, 12, 3)))
    for extra in ([], ["--path", "library"], ["--exec"], ["--chained", "2"]):
        assert cli.main([img, str(tmp_path / "out"), *extra]) == 4
    assert "No CUDA device" in capsys.readouterr().err


# -- on the card ------------------------------------------------------------

def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["kernel", "library"])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_graph_replay_equals_direct_calls(path, dtype):
    session = BenchmarkSession(image((37, 53, 3)), card(), dtype=dtype,
                               path=path)
    src = session._device_input()
    graphs = exec_timing.GraphCache()
    for col, fn in session._ops.items():
        for k in (1, 3):
            want = exec_timing.chain_direct(fn, src, k)
            assert torch.equal(graphs.replay(col, fn, src, k), want), col


@pytest.mark.cuda
def test_graph_cache_keys_by_shape_and_copies_a_new_input():
    dev = card()
    graphs = exec_timing.GraphCache()
    fn = OPS["Inversion"]
    a = torch.zeros(3, 8, 16, dtype=torch.uint8, device=dev)
    b = torch.full((3, 8, 16), 7, dtype=torch.uint8, device=dev)
    c = torch.zeros(3, 8, 32, dtype=torch.uint8, device=dev)
    assert int(graphs.replay("inv", fn, a, 1)[0, 0, 0]) == 255
    assert int(graphs.replay("inv", fn, b, 1)[0, 0, 0]) == 248
    assert graphs.replay("inv", fn, c, 1).shape == c.shape
    b.fill_(9)
    assert int(graphs.replay("inv", fn, b, 1)[0, 0, 0]) == 246


@pytest.mark.cuda
def test_execution_time_on_card_is_resolved():
    session = BenchmarkSession(image((64, 96, 3)), card())
    t = exec_timing.execution_time("copy", OPS["Copy"],
                                   session._device_input())
    assert t.where == "L2-warm" and np.isfinite(t.per_app_s)
