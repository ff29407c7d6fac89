"""The port's own copy of the NumPy-only layer against the JAX package's:
spec constants, the oracle, the synthetic image and its resolver, image
I/O, timing, reporting and the harness contract. Tolerance 0 everywhere:
these are copies, so they must give the same answers."""

import os

import numpy as np
import pytest

from dip_benchmark_tpu import harness as jax_harness
from dip_benchmark_tpu import oracle as jax_oracle
from dip_benchmark_tpu import spec as jax_spec
from dip_benchmark_tpu.utils import image as jax_image
from dip_benchmark_tpu.utils import reporting as jax_reporting
from dip_benchmark_tpu.utils import testimage as jax_testimage
from dip_benchmark_tpu.utils import timing as jax_timing
from dip_benchmark_tpu_torch import harness, oracle, spec
from dip_benchmark_tpu_torch.utils import image, reporting, testimage, timing

SPEC_NAMES = sorted(n for n in dir(jax_spec)
                    if n.isupper() and not n.startswith("_"))
ORACLE_COLS = sorted(jax_oracle.IMAGE_OPS)
SEEDS = (0, 1, 2)


def random_image(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    h, w = rng.integers(5, 48, size=2)
    return rng.integers(0, 256, (h, w, 3), np.uint8)


@pytest.mark.parametrize("name", SPEC_NAMES)
def test_spec_constant_equals_jax_package(name):
    mine, theirs = getattr(spec, name), getattr(jax_spec, name)
    if isinstance(theirs, np.ndarray):
        assert mine.dtype == theirs.dtype
        np.testing.assert_array_equal(mine, theirs)
    else:
        assert mine == theirs


def test_spec_has_no_constant_the_jax_package_lacks():
    assert sorted(n for n in dir(spec)
                  if n.isupper() and not n.startswith("_")) == SPEC_NAMES


@pytest.mark.parametrize("x", [-2, -1, 0, 3, 6, 7, np.arange(-2, 9)])
def test_mirror_index_equals_jax_package(x):
    np.testing.assert_array_equal(spec.mirror_index(x, 7),
                                  jax_spec.mirror_index(x, 7))


@pytest.mark.parametrize("col", ORACLE_COLS)
def test_oracle_equals_jax_package(col):
    assert len(ORACLE_COLS) == 13 and set(oracle.IMAGE_OPS) == set(
        ORACLE_COLS)
    for seed in SEEDS:
        img = random_image(seed)
        got = oracle.IMAGE_OPS[col](img)
        assert got.dtype == np.uint8 and got.shape == img.shape
        np.testing.assert_array_equal(got, jax_oracle.IMAGE_OPS[col](img),
                                      err_msg=f"{col} seed {seed}")


def test_oracle_dilation_equals_jax_package():
    img = random_image(3)
    np.testing.assert_array_equal(oracle.dilation_separated(img),
                                  jax_oracle.dilation_separated(img))


@pytest.mark.parametrize("hw", [(64, 96), (5, 7)])
def test_synth_fundus_equals_jax_package(hw):
    np.testing.assert_array_equal(testimage.synth_fundus(*hw),
                                  jax_testimage.synth_fundus(*hw))


def test_resolve_image_follows_the_same_variables(tmp_path, monkeypatch):
    monkeypatch.delenv("DIP_TPU_IMAGE", raising=False)
    monkeypatch.setenv("DIP_TPU_REF", str(tmp_path / "nowhere"))
    mine, label = testimage.resolve_image(height=24, width=40)
    theirs, jax_label = jax_testimage.resolve_image(height=24, width=40)
    assert label == jax_label == "synth_fundus(24x40)"
    np.testing.assert_array_equal(mine, theirs)

    # The reference photograph under $DIP_TPU_REF wins over the synthetic.
    os.makedirs(tmp_path / "ref" / "assets")
    photo = random_image(4)
    image.save_image(str(tmp_path / "ref" / "assets" / "fundus.jpg"), photo)
    monkeypatch.setenv("DIP_TPU_REF", str(tmp_path / "ref"))
    mine, label = testimage.resolve_image()
    theirs, jax_label = jax_testimage.resolve_image()
    assert label == jax_label == "fundus.jpg"
    np.testing.assert_array_equal(mine, theirs)

    # An explicit image wins over both.
    path = str(tmp_path / "given.png")
    image.save_image(path, photo)
    monkeypatch.setenv("DIP_TPU_IMAGE", path)
    mine, label = testimage.resolve_image()
    assert label == "given.png"
    np.testing.assert_array_equal(mine, photo)


@pytest.mark.parametrize("ext", ["png", "bmp"])
def test_image_io_equals_jax_package(ext, tmp_path):
    img = random_image(5)
    path = str(tmp_path / f"a.{ext}")
    image.save_image(path, img)
    assert image.is_image_file(path) and jax_image.is_image_file(path)
    np.testing.assert_array_equal(image.load_image(path), img)
    np.testing.assert_array_equal(jax_image.load_image(path), img)
    (tmp_path / "not.png").write_text("not an image")
    for mod in (image, jax_image):
        assert not mod.is_image_file(str(tmp_path / "not.png"))
        assert not mod.is_image_file(str(tmp_path / "missing.png"))


@pytest.mark.parametrize("bad", [
    np.zeros((4, 4, 3), np.int32),
    np.zeros((4, 4), np.uint8),
    np.zeros((4, 4, 4), np.uint8),
    [[1, 2, 3]],
])
def test_check_uint8_hwc_refuses_like_jax_package(bad):
    with pytest.raises(ValueError, match="uint8 HWC"):
        image.check_uint8_hwc(bad)
    with pytest.raises(ValueError, match="uint8 HWC"):
        jax_image.check_uint8_hwc(bad)


@pytest.mark.parametrize("n", [1, 2, 19, 20, 21, 100])
def test_p95_equals_jax_package(n):
    samples = list(range(n))
    assert timing.p95_nearest_rank(samples) == jax_timing.p95_nearest_rank(
        samples)


def test_measure_time_counts_calls():
    calls = []
    once, mean = timing.measure_time(lambda: calls.append(1), 5, warmup=2)
    assert len(calls) == 8 and once >= 0 and mean >= 0
    once, mean, stats = timing.measure_time_stats(
        lambda: calls.append(1), 4, warmup=1)
    assert len(calls) == 14 and len(stats["samples"]) == 4
    assert stats["min"] <= stats["p50"] <= stats["p95"] <= stats["max"]


def test_reporting_equals_jax_package(tmp_path):
    rows = [("Copy", "copy", "Copy", 0.5, 0.25),
            ("Fused Pipeline", "pipeline", "Fused-Pipeline", 1.0, 0.125)]
    mine = [reporting.OpResult(*r, rounds=7) for r in rows]
    theirs = [jax_reporting.OpResult(*r, rounds=7) for r in rows]
    for a, b in zip(mine, theirs):
        assert reporting.format_row(a, width=20) == jax_reporting.format_row(
            b, width=20)
    # The pipeline has no CSV column; the row has one cell per column.
    assert reporting.csv_row("t", mine) == jax_reporting.csv_row("t", theirs)
    a, b = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    for tool in ("x", "y", "x"):
        reporting.write_csv(a, tool, mine)
        jax_reporting.write_csv(b, tool, theirs)
    with open(a) as fa, open(b) as fb:
        assert fa.read() == fb.read()


def make_ops(module, outputs: dict, log: list):
    def op(col, downloads=False):
        desc, prefix, _ = module.op_matrix_entry(col)
        return module.Operation(desc, prefix, col,
                                lambda: log.append(("run", col)),
                                lambda: outputs[col], downloads=downloads)
    return [op("Download", downloads=True), op("Copy"), op("Inversion")]


@pytest.mark.parametrize("stats", [False, True])
def test_harness_runs_like_jax_package(stats, tmp_path, capsys):
    # Same rows, same call order (download measured last, then one untimed
    # run per image op for the dump), same files.
    img = random_image(6)
    outputs = {"Copy": img, "Inversion": 255 - img}
    runs = {}
    for name, module, kw in (
            ("port", harness, {"verify_ops": oracle.IMAGE_OPS}),
            ("jax", jax_harness, {"verify_ops": jax_oracle.IMAGE_OPS})):
        log = []
        runner = module.BenchmarkRunner(
            make_ops(module, outputs, log), rounds=3, stats=stats, warmup=1,
            rounds_override={"Download": 1})
        out = tmp_path / name
        out.mkdir()
        runner.run(filename="x.png", outdir=str(out), verify_against=img,
                   **kw)
        rows = [ln for ln in capsys.readouterr().out.splitlines()]
        runs[name] = (log, [r.split("|")[1].split(":")[0] for r in rows],
                      [r.rounds for r in runner.results],
                      sorted(os.listdir(out)))
    assert runs["port"] == runs["jax"]
    log, _, rounds, files = runs["port"]
    assert rounds == [1, 3, 3] and files == ["copy-x.png", "inversion-x.png"]
    assert log[-5:] == [("run", "Download")] * 3 + [("run", "Copy"),
                                                    ("run", "Inversion")]


def test_harness_verify_reports_every_failure():
    img = random_image(7)
    outputs = {"Copy": img, "Inversion": img}  # Inversion is wrong
    runner = harness.BenchmarkRunner(make_ops(harness, outputs, []),
                                     rounds=1)
    with pytest.raises(AssertionError, match="Inversion: .* px differ"):
        runner.run(verify_against=img, verify_ops=oracle.IMAGE_OPS)


def test_harness_needs_the_oracle_to_verify():
    runner = harness.BenchmarkRunner(make_ops(harness, {}, []), rounds=1)
    with pytest.raises(ValueError, match="verify_ops"):
        runner.run(verify_against=random_image(8))


def test_op_matrix_entry_equals_jax_package():
    for _, _, col in spec.OPERATION_MATRIX:
        assert harness.op_matrix_entry(col) == jax_harness.op_matrix_entry(
            col)
    with pytest.raises(KeyError):
        harness.op_matrix_entry("Fused-Pipeline")
