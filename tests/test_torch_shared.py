"""The port's own copy of the NumPy-only layer against the JAX package's:
spec constants, the oracle and the f32 oracle, the synthetic image and its
resolver, image I/O, timing, reporting and the harness contract, with its
don't-care verify. Tolerance 0 everywhere: these are copies, so they must
give the same answers."""

import os

import numpy as np
import pytest

from dip_benchmark_tpu import harness as jax_harness
from dip_benchmark_tpu import oracle as jax_oracle
from dip_benchmark_tpu import oracle_f32 as jax_oracle_f32
from dip_benchmark_tpu import spec as jax_spec
from dip_benchmark_tpu.utils import image as jax_image
from dip_benchmark_tpu.utils import reporting as jax_reporting
from dip_benchmark_tpu.utils import testimage as jax_testimage
from dip_benchmark_tpu.utils import timing as jax_timing
from dip_benchmark_tpu_torch import harness, oracle, oracle_f32, spec
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


@pytest.mark.parametrize("col", sorted(jax_oracle_f32.IMAGE_OPS_F32))
def test_oracle_f32_equals_jax_package(col):
    assert set(oracle_f32.IMAGE_OPS_F32) == set(jax_oracle_f32.IMAGE_OPS_F32)
    for seed in SEEDS:
        x = oracle_f32.from_uint8_hwc(random_image(seed))
        np.testing.assert_array_equal(
            x, jax_oracle_f32.from_uint8_hwc(random_image(seed)))
        got = oracle_f32.IMAGE_OPS_F32[col](x)
        assert got.dtype == np.float32 and got.shape == x.shape
        np.testing.assert_array_equal(
            got, jax_oracle_f32.IMAGE_OPS_F32[col](x),
            err_msg=f"{col} seed {seed}")
        np.testing.assert_array_equal(oracle_f32.to_uint8_hwc(got),
                                      jax_oracle_f32.to_uint8_hwc(got))


def boundary_image() -> np.ndarray:
    # rgb (126, 139, 18) has an f32 luma of exactly 0.5 in NumPy's order
    # (tests/test_f32_path.py's boundary case).
    img = np.full((16, 20, 3), 40, np.uint8)
    img[5, 7] = (126, 139, 18)
    return img


@pytest.mark.parametrize("col", sorted(jax_oracle_f32.IMAGE_OPS_F32))
def test_f32_verify_ops_equal_jax_package(col):
    mine = oracle_f32.uint8_verify_ops()[col]
    theirs = jax_oracle_f32.uint8_verify_ops()[col]
    for img in (random_image(9), boundary_image()):
        a, b = mine(img), theirs(img)
        assert isinstance(a, tuple) == isinstance(b, tuple)
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(x, y, err_msg=col)
    # Only the pipeline, and only at a luma on the step, gets a mask.
    assert isinstance(mine(boundary_image()), tuple) == (
        col == "Fused-Pipeline")


def test_f32_boundary_mask_covers_the_spread():
    expected, mask = oracle_f32.uint8_verify_ops()["Fused-Pipeline"](
        boundary_image())
    assert expected.shape == mask.shape == (16, 20, 3)
    assert mask[5, 7].all() and mask[7, 9].all()   # pixel + radius-2 spread
    assert not mask[5, 12].any()                   # outside the dilation


def test_near_threshold_and_dilate_mask_equal_jax_package():
    rng = np.random.default_rng(10)
    x = rng.random((3, 9, 11), dtype=np.float32)
    x[1, 2, 3] = np.float32(0.5)
    x[0, 6, 8] = np.float32(0.5) + np.float32(2 ** -23)
    x[2, 0, 0] = np.float32(0.5) - np.float32(2 ** -21)  # outside 4 ulps
    near = oracle_f32.near_threshold_mask(x)
    np.testing.assert_array_equal(near, jax_oracle_f32.near_threshold_mask(x))
    assert near[2, 3] and near[6, 8] and not near[0, 0]
    assert oracle_f32.THRESHOLD_ULP_SLACK == jax_oracle_f32.THRESHOLD_ULP_SLACK
    for ry, rx in ((0, 0), (1, 2), (2, 2)):
        np.testing.assert_array_equal(
            oracle_f32.dilate_mask(near, ry, rx),
            jax_oracle_f32.dilate_mask(near, ry, rx))
    empty = np.zeros((4, 5), bool)
    assert not oracle_f32.dilate_mask(empty, 2, 2).any()


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


@pytest.mark.parametrize("stats", [False, True])
def test_harness_time_scale_like_jax_package(stats, monkeypatch, capsys):
    # One chained round runs time_scale applications: both harnesses divide
    # the repeated column and the latency distribution by it, and leave
    # the once column whole. A clock that advances 1000 ns a read makes
    # the times equal across the two.
    results = {}
    for name, module, clock in (("port", harness, timing),
                                ("jax", jax_harness, jax_timing)):
        ticks = iter(range(0, 10 ** 9, 1000))
        monkeypatch.setattr(clock, "_clock_ns", lambda: next(ticks))
        desc, prefix, _ = module.op_matrix_entry("Copy")
        ops = [module.Operation(desc, prefix, "Copy", lambda: None,
                                lambda: None, time_scale=4)]
        runner = module.BenchmarkRunner(ops, rounds=3, stats=stats,
                                        warmup=1)
        runner.run()
        r = runner.results[0]
        results[name] = (r.time_once, r.time_rounds, r.rounds,
                         runner.op_stats)
    capsys.readouterr()
    assert results["port"] == results["jax"]
    once, rounds_s, n, op_stats = results["port"]
    assert n == 3 and once == pytest.approx(1e-6)
    # measure_time reads the clock around the loop, measure_time_stats
    # after every round.
    assert rounds_s == pytest.approx((1e-6 if stats else 1e-6 / 3) / 4)
    if stats:
        assert op_stats["Copy"]["p50"] == pytest.approx(1e-6 / 4)


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


@pytest.mark.parametrize("masked", [True, False])
def test_harness_verify_respects_dontcare_mask_like_jax_package(masked):
    # An oracle that returns (expected, dontcare): the delta under the mask
    # is zeroed. The port's harness passes and fails exactly where the
    # JAX package's does.
    img = np.zeros((4, 4, 3), np.uint8)
    got = np.zeros((4, 4, 3), np.uint8)
    got[1, 1] = 200
    mask = np.zeros(got.shape, bool)
    mask[1, 1] = masked
    verify = {"Copy": lambda im: (np.zeros_like(got), mask)}
    outcomes = []
    for module, kw in ((harness, {}), (jax_harness, {"quiet": True})):
        op = module.Operation("X", "x", "Copy", lambda: None, lambda: got)
        runner = module.BenchmarkRunner([op], rounds=1)
        try:
            runner.run(verify_against=img, verify_ops=verify, **kw)
            outcomes.append("passed")
        except AssertionError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[0] == "passed") == masked
    if not masked:
        assert outcomes[0].endswith("Copy: 3 px differ (max |delta| = 200)")


def test_harness_dontcare_mask_leaves_other_pixels_strict():
    img = np.zeros((4, 4, 3), np.uint8)
    got = np.zeros((4, 4, 3), np.uint8)
    got[1, 1] = 200
    got[2, 2] = 2       # outside the mask, beyond atol 1
    mask = np.zeros(got.shape, bool)
    mask[1, 1] = True
    op = harness.Operation("X", "x", "Copy", lambda: None, lambda: got)
    with pytest.raises(AssertionError, match=r"Copy: 3 px differ \(max"):
        harness.BenchmarkRunner([op], rounds=1).run(
            verify_against=img, verify_atol=1,
            verify_ops={"Copy": lambda im: (np.zeros_like(got), mask)})
