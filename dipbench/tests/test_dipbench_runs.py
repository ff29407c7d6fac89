"""The harness on the CPU at a tiny image: every cell runs through the
port's plain path and judges itself correct; a new cell is found by name;
without a card the command prints no result; nothing of JAX is loaded."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from dipbench import run
from dipbench.reference import fundus, ops as ref

ROOT = run.ROOT
SIZE = (21, 34)
BIG_SEED = 2**31 + 977
CELLS = [w["name"] for w in run.Bench().spec["workloads"]]


def quiet(_):
    pass


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_runs_on_the_plain_path(cell, trace):
    r = run.run_cell(run.Bench(), cell, BIG_SEED, 0.05, bool(trace),
                     torch.device("cpu"), size=SIZE, log=quiet)
    assert r["correct"] is True
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "check"
    assert r["check"]["level_gap"]["value"] == 0
    bench = run.Bench()
    if trace:
        # No CUDA activity on the CPU: the device readers find nothing.
        names = {m["name"] for m in bench.per_layer(bench.cell(cell))}
        assert set(r["metrics"]) <= names
        assert "busy_s" not in r["device"]
    else:
        want = {m["name"] for m in bench.end_to_end(bench.cell(cell))}
        assert set(r["metrics"]) == want
        assert all(v["value"] > 0 for v in r["metrics"].values())


def _with_cell(tmp_path, cell, mix=None, driver=None):
    """A copy of the benchmark in ``tmp_path`` with one more cell (and
    mix, and driver file), added as a later change would add them."""
    shutil.copytree(os.path.join(ROOT, "dipbench"), tmp_path / "dipbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    if mix is not None:
        (tmp_path / "dipbench/mixes" / (cell["traffic"] + ".json")
         ).write_text(json.dumps(mix))
    if driver is not None:
        shutil.copy(os.path.join(ROOT, "dipbench/drivers", driver[0] + ".py"),
                    tmp_path / "dipbench/drivers" / (driver[1] + ".py"))
    limit = 1.0 if cell["config"] == "fundus-f32" else 0
    (tmp_path / "dipbench/workloads" / (cell["name"] + ".json")).write_text(
        json.dumps({"limits": {"level_gap": limit}}))
    return run.Bench(str(tmp_path))


NEW_CELLS = {
    # the memory rows and a fused chain, from data alone
    "fundus-u8.memory": ("fundus-u8", {"driver": "rounds", "rows": [
        "Upload", "Download", "Copy"], "fuse": [["Convolution-5x5",
                                                 "Inversion"]]}),
    "fundus-f32.memory": ("fundus-f32", {"driver": "rounds", "rows": [
        "Upload", "Download", "Fused-Pipeline"]}),
    # an existing mix in the other configuration
    "fundus-f32.sync": ("fundus-f32", None),
    # a chain through the batch tool
    "fundus-u8.batch-chain": ("fundus-u8", {"driver": "batch", "op": [
        "Grayscale", "Erosion-3x3-Square"], "batch": 3, "sample": 2}),
}


def test_a_new_cell_is_found_by_name(tmp_path):
    bench = _with_cell(tmp_path, {"name": "fundus-f32.short", "config":
                                  "fundus-f32", "traffic": "short",
                                  "chips": 1, "why": "a test cell"},
                       {"driver": "rounds", "k": 3, "warmup": 1,
                        "trace_rounds": 4})
    bench.spec["end_to_end"][1]["workloads"].append("fundus-f32.short")
    r = run.run_cell(bench, "fundus-f32.short", 5, 0.05, False,
                     torch.device("cpu"), size=SIZE, log=quiet)
    assert r["correct"] is True
    assert set(r["metrics"]) == {"app_us.f32", "setup_s"}


@pytest.mark.parametrize("name", list(NEW_CELLS))
def test_a_new_mix_is_data_alone(tmp_path, name):
    config, mix = NEW_CELLS[name]
    traffic = name.split(".")[1]
    bench = _with_cell(tmp_path, {"name": name, "config": config,
                                  "traffic": traffic, "chips": 1,
                                  "why": "a test cell"}, mix)
    r = run.run_cell(bench, name, BIG_SEED, 0.05, False,
                     torch.device("cpu"), size=SIZE, log=quiet)
    assert r["correct"] is True
    assert r["check"]["outputs_missing"]["value"] == 0


def test_a_new_traffic_kind_is_a_new_driver_file(tmp_path):
    bench = _with_cell(tmp_path, {"name": "fundus-u8.other", "config":
                                  "fundus-u8", "traffic": "other",
                                  "chips": 1, "why": "a test cell"},
                       {"driver": "other_rounds", "k": 2},
                       driver=("rounds", "other_rounds"))
    traffic = bench.driver(bench.mix(bench.cell("fundus-u8.other")))
    assert traffic.__file__.startswith(str(tmp_path))
    r = run.run_cell(bench, "fundus-u8.other", 7, 0.05, False,
                     torch.device("cpu"), size=SIZE, log=quiet)
    assert r["correct"] is True


def _command(cwd, *extra):
    return subprocess.run(
        [sys.executable, "dipbench/run.py", "--workload", "fundus-u8.sync",
         "--seed", str(BIG_SEED), "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=120)


def test_without_a_card_the_command_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = _command(ROOT)
    assert p.returncode == 3
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_without_the_port_the_command_prints_no_result(tmp_path):
    shutil.copytree(os.path.join(ROOT, "dipbench"), tmp_path / "dipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    p = _command(str(tmp_path))
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_a_run_loads_nothing_of_jax():
    code = (
        "import sys, torch; sys.path.insert(0, %r)\n"
        "from dipbench import run\n"
        "run.run_cell(run.Bench(), 'fundus-u8.sync', 3, 0.05, True,\n"
        "             torch.device('cpu'), size=(21, 34), log=lambda s: 0)\n"
        "run.run_cell(run.Bench(), 'fundus-u8.batch', 3, 0.05, False,\n"
        "             torch.device('cpu'), size=(21, 34), log=lambda s: 0)\n"
        "print(run.forbidden_modules())\n" % ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == "[]"


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _sources(folder):
    for dirpath, _, files in os.walk(folder):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def test_no_file_imports_jax_and_the_reference_nothing_of_the_port():
    for path in _sources(os.path.join(ROOT, "dipbench")):
        for mod in _imports(path):
            assert mod.split(".")[0] not in run.FORBIDDEN, (path, mod)
    for path in _sources(os.path.join(ROOT, "dipbench", "reference")):
        for mod in _imports(path):
            assert mod.split(".")[0] != "dip_benchmark_tpu_torch", (path,
                                                                    mod)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "dip_benchmark_tpu_torch_x", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax"]


def test_the_seed_sets_the_inputs():
    a = fundus.fundus(40, 60, BIG_SEED)
    assert torch.equal(a, fundus.fundus(40, 60, BIG_SEED))
    assert not torch.equal(a, fundus.fundus(40, 60, BIG_SEED + 1))
    p = fundus.pool(a, 8, BIG_SEED)
    assert p.shape == (8, 40, 60, 3) and torch.equal(p[0], a)
    assert len({bytes(im.numpy()) for im in p}) == 8


@pytest.mark.parametrize("col", list(ref.OPS))
def test_one_application_is_the_oracle(col):
    # The reference's single application, through the bake and the crop,
    # equals the port's NumPy oracle (which the reference does not use).
    from dip_benchmark_tpu_torch import oracle
    from dipbench import check
    image = fundus.fundus(23, 31, 11)
    got = check.single([col], image, "uint8", "int32")[0].numpy()
    fn = (oracle.fused_pipeline if col == "Fused-Pipeline"
          else oracle.IMAGE_OPS[col])
    assert (got == fn(image.numpy())).all()


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = _command(ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
