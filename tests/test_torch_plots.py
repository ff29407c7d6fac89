"""The port's reporting module (``utils/plots.py``) on CSVs that the port's
CLI wrote, against the JAX package's module, and the ``testimage``
command line."""

import json
import os
import subprocess
import sys

import matplotlib.axes
import numpy as np
import pytest

from dip_benchmark_tpu.utils import plots as jax_plots
from dip_benchmark_tpu.utils.testimage import synth_fundus as jax_fundus
from dip_benchmark_tpu_torch import cli, spec
from dip_benchmark_tpu_torch.utils import plots
from dip_benchmark_tpu_torch.utils.image import load_image, save_image
from dip_benchmark_tpu_torch.utils.testimage import synth_fundus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICE_OPS = [c for c in spec.CSV_COLUMNS if c not in ("Upload", "Download")]


def cli_csv(tmp_path, image, *extra) -> str:
    """results.csv from one CPU run of the port's CLI."""
    path = str(tmp_path / "in.png")
    save_image(path, image)
    csv = str(tmp_path / "results.csv")
    assert cli.main([path, str(tmp_path / "dumps"), "--rounds", "1",
                     "--backend", "cpu", "--csv", csv, *extra]) == 0
    return csv


def add_reference_row(csv: str, tool: str, seconds: float) -> None:
    with open(csv, "a") as f:
        f.write(tool + "," + ",".join([str(seconds)] * len(spec.CSV_COLUMNS))
                + "\n")


def bench_json(tmp_path, ops: dict, wrap: bool = False) -> str:
    doc = {"ops": {col: {"exec_us": us} for col, us in ops.items()}}
    path = str(tmp_path / "bench.json")
    with open(path, "w") as f:
        json.dump({"parsed": doc} if wrap else doc, f)
    return path


def test_group_charts_from_a_port_cli_csv(tmp_path, small_image, capsys):
    csv = cli_csv(tmp_path, small_image)
    tools, data = plots.read_results(csv)
    assert tools == ["CPU-torch"]
    assert list(data) == list(spec.CSV_COLUMNS)
    assert all(v[0] is not None and v[0] > 0 for v in data.values())
    written = plots.render_group_charts(csv, str(tmp_path / "charts"))
    assert [os.path.basename(p) for p in written] == [
        f"{name}.png" for name in plots.OP_GROUPS]
    assert all(os.path.getsize(p) > 0 for p in written)


def test_group_charts_tolerate_partial_rows(tmp_path, small_image, capsys):
    # A --chained run times no memory op: its Upload and Download cells
    # are empty, and every chart still renders.
    csv = cli_csv(tmp_path, small_image, "--chained", "2")
    tools, data = plots.read_results(csv)
    assert data["Upload"] == data["Download"] == [None]
    assert all(data[c][0] is not None for c in DEVICE_OPS)
    written = plots.render_group_charts(csv, str(tmp_path / "charts"))
    assert len(written) == len(plots.OP_GROUPS)


def test_read_results_and_groups_equal_the_jax_module(tmp_path, small_image,
                                                      capsys):
    csv = cli_csv(tmp_path, small_image, "--chained", "2")
    add_reference_row(csv, "CUDA.jl", 0.001)
    assert plots.read_results(csv) == jax_plots.read_results(csv)
    assert plots.OP_GROUPS == jax_plots.OP_GROUPS


@pytest.fixture
def bar_labels(monkeypatch):
    """The labels of every bar series the charts draw."""
    labels = []
    real = matplotlib.axes.Axes.barh

    def barh(self, *args, label=None, **kwargs):
        labels.append(label)
        return real(self, *args, label=label, **kwargs)

    monkeypatch.setattr(matplotlib.axes.Axes, "barh", barh)
    return labels


@pytest.mark.parametrize("wrap", [False, True])
def test_exec_chart_leaves_out_the_ports_own_rows(wrap, tmp_path, small_image,
                                                  bar_labels, capsys):
    csv = cli_csv(tmp_path, small_image)
    cli_csv(tmp_path, small_image, "--path", "library")
    add_reference_row(csv, "CUDA.jl", 0.002)
    add_reference_row(csv, "TPU-pallas", 0.0005)
    exec_json = bench_json(tmp_path, {c: 15.0 for c in DEVICE_OPS}, wrap)
    out = plots.render_exec_chart(csv, exec_json, str(tmp_path / "e.png"))
    assert os.path.getsize(out) > 0
    assert plots.read_results(csv)[0] == [
        "CPU-torch", "CPU-torch-library", "CUDA.jl", "TPU-pallas"]
    assert bar_labels == [
        "CUDA.jl (per-round, partly async)",
        "TPU-pallas (per-round, partly async)",
        "this port (device execution time per application)"]
    assert "NOTE" not in capsys.readouterr().err


def test_exec_chart_notes_a_dropped_op(tmp_path, small_image, capsys):
    # The branch the JAX module reaches with sys unimported: an op whose
    # exec_us is missing or 0 is dropped with a NOTE on stderr.
    csv = cli_csv(tmp_path, small_image)
    ops = {c: 20.0 for c in DEVICE_OPS}
    ops["Threshold"] = 0
    del ops["Copy"]
    out = str(tmp_path / "e.png")
    plots.render_exec_chart(csv, bench_json(tmp_path, ops), out)
    err = capsys.readouterr().err
    assert err.startswith("NOTE: no exec_us for Copy, Threshold")
    assert out in err and os.path.getsize(out) > 0


def test_exec_chart_without_exec_us_raises(tmp_path, small_image, capsys):
    csv = cli_csv(tmp_path, small_image)
    with pytest.raises(ValueError, match="no per-op exec_us"):
        plots.render_exec_chart(
            csv, bench_json(tmp_path, {c: 0 for c in DEVICE_OPS}),
            str(tmp_path / "e.png"))


def test_port_tools_are_the_clis_tool_names():
    import torch
    assert sorted(plots.PORT_TOOLS) == sorted(
        cli.default_tool(torch.device(d), p)
        for d in ("cuda", "cpu") for p in ("kernel", "library"))


def test_plots_command_line(tmp_path, small_image, capsys):
    csv = cli_csv(tmp_path, small_image)
    exec_json = bench_json(tmp_path, {c: 15.0 for c in DEVICE_OPS}, True)
    outdir = tmp_path / "charts"
    proc = subprocess.run(
        [sys.executable, "-m", "dip_benchmark_tpu_torch.utils.plots", csv,
         str(outdir), "--exec-json", exec_json], cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO, "MPLBACKEND": "Agg"},
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    names = [f"{name}.png" for name in plots.OP_GROUPS]
    names.append("execution-comparison.png")
    assert sorted(os.listdir(outdir)) == sorted(names)
    assert proc.stdout.count("Saved plot: ") == 6


def test_testimage_command_line(tmp_path):
    out = str(tmp_path / "out.png")
    proc = subprocess.run(
        [sys.executable, "-m", "dip_benchmark_tpu_torch.utils.testimage",
         out, "--height", "40", "--width", "56"], cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO}, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == f"wrote {out} (40x56)"
    written = load_image(out)
    assert written.shape == (40, 56, 3)
    np.testing.assert_array_equal(written, synth_fundus(40, 56))
    np.testing.assert_array_equal(written, jax_fundus(40, 56))
