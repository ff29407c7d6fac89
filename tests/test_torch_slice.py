"""The port's main path end to end against the JAX package's: both CLIs run
the uint8 matrix and the fused pipeline on the same image with --verify,
and their image dumps and CSV schemas agree."""

import os

import numpy as np

from dip_benchmark_tpu import cli as jax_cli
from dip_benchmark_tpu import spec
from dip_benchmark_tpu.utils.image import load_image, save_image
from dip_benchmark_tpu_torch import cli
from dip_benchmark_tpu_torch.session import BenchmarkSession

DUMPS = [prefix for _, prefix, _ in spec.OPERATION_MATRIX if prefix]
PIPELINE_ROW = "Fused Pipeline (Grayscale+Threshold+Erosion+Blur)"


def table_rows(text: str) -> list[str]:
    return [ln for ln in text.splitlines() if ln.startswith("| ")]


def test_port_cli_matches_jax_cli(tmp_path, small_image, capsys):
    img = str(tmp_path / "small.png")
    save_image(img, small_image)
    common = ["--rounds", "2", "--backend", "cpu", "--verify",
              "--warmup", "0", "--pipeline"]

    port_out, port_csv = tmp_path / "port", str(tmp_path / "port.csv")
    assert cli.main([img, str(port_out), *common, "--csv", port_csv]) == 0
    port_rows = table_rows(capsys.readouterr().out)

    jax_out, jax_csv = tmp_path / "jax", str(tmp_path / "jax.csv")
    assert jax_cli.main([img, str(jax_out), *common, "--path", "pallas",
                         "--csv", jax_csv]) == 0
    jax_rows = table_rows(capsys.readouterr().out)

    assert len(port_rows) == len(jax_rows) == 15
    assert [r.split("|")[1] for r in port_rows] == [
        r.split("|")[1] for r in jax_rows]
    assert port_rows[-1].split("|")[1].strip() == PIPELINE_ROW
    assert len(DUMPS) == 12
    assert sorted(os.listdir(port_out)) == sorted(os.listdir(jax_out))
    for prefix in DUMPS + ["pipeline"]:
        name = f"{prefix}-small.png"
        np.testing.assert_array_equal(load_image(str(port_out / name)),
                                      load_image(str(jax_out / name)),
                                      err_msg=name)
    with open(port_csv) as f:
        port_lines = f.read().splitlines()
    with open(jax_csv) as f:
        jax_lines = f.read().splitlines()
    # No column for the pipeline: the CSV keeps the reference schema.
    assert port_lines[0] == jax_lines[0] == spec.CSV_HEADER
    assert port_lines[1].startswith("CPU-torch,")
    assert len(port_lines[1].split(",")) == len(jax_lines[1].split(",")) \
        == len(spec.CSV_COLUMNS) + 1


def test_port_cli_knobs(tmp_path, gradient_image, capsys):
    # Positional rounds, --mem-rounds and --stats, and a CSV row replaced
    # in place on a second run.
    img = str(tmp_path / "grad.png")
    save_image(img, gradient_image)
    csv = str(tmp_path / "r.csv")
    args = [img, str(tmp_path / "out"), "3", "--backend", "cpu",
            "--mem-rounds", "1", "--stats", "--csv", csv, "--tool", "t"]
    assert cli.main(args) == 0
    assert cli.main(args) == 0
    rows = table_rows(capsys.readouterr().out)
    ops = [r for r in rows if not r.startswith("|   latency")]
    assert len(ops) == 28 and len(rows) == 56
    assert "(1 times)" in ops[0] and "(3 times)" in ops[2]
    with open(csv) as f:
        lines = f.read().splitlines()
    assert len(lines) == 2 and lines[1].startswith("t,")
    assert sorted(os.listdir(tmp_path / "out")) == sorted(
        f"{p}-grad.png" for p in DUMPS)


def test_port_cli_refuses_a_foreign_csv(tmp_path, small_image):
    img = str(tmp_path / "small.png")
    save_image(img, small_image)
    csv = tmp_path / "foreign.csv"
    csv.write_text("a,b,c\n1,2,3\n")
    assert cli.main([img, str(tmp_path / "out"), "--rounds", "1",
                     "--backend", "cpu", "--csv", str(csv)]) == 2
    assert csv.read_text() == "a,b,c\n1,2,3\n"


def test_pipeline_row_is_opt_in(small_image):
    session = BenchmarkSession(small_image, "cpu")
    plain = session.operations()
    table = session.operations(include_pipeline=True)
    assert len(plain) == 14 and len(table) == 15
    row = table[-1]
    assert (row.description, row.prefix, row.csv_column) == (
        PIPELINE_ROW, "pipeline", "Fused-Pipeline")
    row.run()
    np.testing.assert_array_equal(
        row.fetch(), session.oracle_ops()["Fused-Pipeline"](small_image))
