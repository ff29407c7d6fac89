"""The check fails what it has to fail: the control (the reference in the
precision below the configuration's), and a run whose timed path is
broken underneath; and the trace reduction's sums."""

import pytest
import torch

from dipbench import control, drive, run, trace
from dipbench.reference import ops as ref

SIZE = (21, 34)
CELLS = [w["name"] for w in run.Bench().spec["workloads"]]
ROUND_CELLS = [c for c in CELLS if not c.endswith(".batch")]
BATCH_CELLS = [c for c in CELLS if c.endswith(".batch")]


def quiet(_):
    pass


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 77])
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell, seed):
    r = control.readings(run.Bench(), cell, seed, torch.device("cpu"),
                         size=(48, 80))
    assert not r["level_gap"] <= r["limit"], r


def _run(cell, size=SIZE):
    return run.run_cell(run.Bench(), cell, 9, 0.05, False,
                        torch.device("cpu"), size=size, log=quiet)


def _tables(cell):
    from dip_benchmark_tpu_torch import ops
    f32 = run.Bench().config(run.Bench().cell(cell))["dtype"] == "float32"
    return ops.OPS_F32 if f32 else ops.OPS


def _unchanged(x):
    return x.clone()


def _half_rows(fn):
    def op(x):
        out = fn(x)
        h = out.shape[-2] // 2
        out[..., h:, :] = x[..., h:, :]
        return out
    return op


def _one_value_off(fn):
    def op(x):
        out = fn(x).clone()
        c, y, w = (s // 2 for s in out.shape[-3:])
        bump = 1 if out.dtype == torch.uint8 else 2 / 255
        flat = out.reshape(-1, *out.shape[-3:])
        flat[:, c, y, w] = (flat[:, c, y, w] + bump) if out.dtype != \
            torch.uint8 else flat[:, c, y, w] ^ 1
        return out
    return op


FAULTS = {
    "state unchanged": lambda fn: _unchanged,
    "half the rows left out": _half_rows,
    "one answer altered": _one_value_off,
}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("cell", ROUND_CELLS)
def test_a_broken_row_is_not_correct(cell, fault, monkeypatch):
    table = _tables(cell)
    col = "Convolution-5x5"
    monkeypatch.setitem(table, col, FAULTS[fault](table[col]))
    r = _run(cell)
    assert r["correct"] is False
    assert r["failed"] > 0


def _half_batch(fn):
    def op(x):
        out = fn(x)
        half = x.shape[0] // 2
        out[half:] = x[half:]
        return out
    return op


BATCH_FAULTS = {
    "state unchanged": lambda fn: _unchanged,
    "half the batch left out": _half_batch,
    "one answer altered": _one_value_off,
}


@pytest.mark.parametrize("fault", list(BATCH_FAULTS))
@pytest.mark.parametrize("cell", BATCH_CELLS)
def test_a_broken_batch_is_not_correct(cell, fault, monkeypatch):
    from dip_benchmark_tpu_torch.models import batch
    monkeypatch.setattr(batch, "fused_pipeline",
                        BATCH_FAULTS[fault](batch.fused_pipeline))
    r = _run(cell, size=(48, 80))
    assert r["correct"] is False


def test_a_missing_output_is_not_correct(monkeypatch):
    rounds = run.Bench().driver({"driver": "rounds"})
    whole = rounds.Driver.outputs
    monkeypatch.setattr(rounds.Driver, "outputs",
                        lambda self: {k: v for k, v in whole(self).items()
                                      if k != "Copy"})
    r = _run("fundus-u8.sync")
    assert r["correct"] is False
    assert r["check"]["outputs_missing"]["value"] == 1


def test_nan_is_not_within_any_limit():
    from dipbench import check
    a = torch.zeros(3, 4, 5)
    b = a.clone()
    b[1, 2, 3] = float("nan")
    g = check.gap(b, a, "float32")
    assert not g <= 1.0


def test_dontcare_masks_only_its_pixels():
    from dipbench import check
    a = torch.zeros(3, 4, 5)
    b = a.clone()
    b[:, 1, 1] = 1.0
    care = torch.zeros(4, 5, dtype=torch.bool)
    care[1, 1] = True
    assert check.gap(b, a, "float32", care) == 0
    b[0, 2, 2] = 0.5
    assert check.gap(b, a, "float32", care) == pytest.approx(127.5)


def test_the_f32_pipeline_masks_lumas_at_the_step():
    # Grey (0.5, 0.5, 0.5) has a luma within ulps of the step.
    planar = torch.full((3, 9, 16), 0.5)
    _, care = ref.apply_k("Fused-Pipeline", planar, 2, "float32")
    assert care is not None and bool(care.all())
    _, none = ref.apply_k("Fused-Pipeline", torch.full((3, 9, 16), 0.9), 2,
                          "float32")
    assert none is None


def _ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def test_trace_sums_over_the_window():
    events = [
        _ev("user_annotation", "dipbench.window", 0, 100),
        _ev("user_annotation", "round:Copy", 0, 40),
        _ev("user_annotation", "round:Grayscale", 50, 45),
        _ev("cuda_runtime", "cudaLaunchKernel", 2, 3, correlation=1),
        _ev("cuda_runtime", "cudaGraphLaunch", 52, 3, correlation=2),
        _ev("cuda_runtime", "cudaMemcpyAsync", 60, 1, correlation=3),
        _ev("kernel", "void dip::copy_u8(unsigned char*)", 10, 20,
            correlation=1),
        _ev("kernel", "void grayscale_u8<3>(int)", 60, 10, correlation=2),
        _ev("kernel", "void grayscale_u8<3>(int)", 65, 10, correlation=2),
        _ev("gpu_memcpy", "Memcpy HtoD", 80, 4, correlation=3,
            bytes=4000),
        _ev("kernel", "late", 98, 10, correlation=99),
    ]
    s = trace.summarize({"traceEvents": events})
    assert s.window_us == 100
    # [10, 30] + [60, 75] + [80, 84] + [98, 100]
    assert s.busy_us == pytest.approx(20 + 15 + 4 + 2)
    assert s.idle_pct == pytest.approx(59)
    copy, gray = s.rounds
    assert (copy.name, copy.kernel_us) == ("Copy", 20)
    assert (gray.name, gray.kernel_us) == ("Grayscale", 20)
    assert (gray.copy_bytes, gray.copy_us) == (4000, 4)
    # [60, 75] and [80, 84]; the late kernel belongs to no round
    assert (copy.busy_us, gray.busy_us) == (20, 19)
    assert s.busy_by_kind() == {"Copy": 20, "Grayscale": 19}
    assert s.device_us_by_name == {"copy_u8": 20, "grayscale_u8<3>": 20,
                                   "Memcpy HtoD": 4, "late": 2}
    bd = s.breakdown()
    assert bd["device_ops"][0][1] == pytest.approx(20e-6)
    assert dict((k, v) for k, v in bd["idle_gaps"]) == pytest.approx(
        {"Copy": 10e-6, "Grayscale": 35e-6, "outside rounds": 14e-6})


def test_a_trace_without_device_activity_reads_nothing():
    events = [_ev("user_annotation", "dipbench.window", 0, 100)]
    assert trace.summarize({"traceEvents": events}) is None
    assert trace.summarize({"traceEvents": []}) is None


def test_roofline_and_copy_readers():
    bench = run.Bench()
    cell = bench.cell("fundus-f32.chained")
    events = [
        _ev("user_annotation", "dipbench.window", 0, 3000),
        _ev("user_annotation", "round:Copy", 0, 2000),
        _ev("cuda_runtime", "cudaGraphLaunch", 1, 1, correlation=7),
        _ev("kernel", "point_f32<Copy>", 10, 1500, correlation=7),
    ]
    # Two untraced rounds of Copy in 6000 us: 3000 us busy.
    ctx = run.Context(cell, bench.config(cell), bench.mix(cell),
                      trace.summarize({"traceEvents": events}), None,
                      drive.Window(0.006, 2, 40))
    roof = bench.reader("f32_kernels_roofline")(ctx)
    assert roof == pytest.approx(100 * 20 * 196_448_256 / 3.35e12 / 1500e-6)
    assert bench.reader("memcpy_gbps.batch")(ctx) is None
    assert bench.reader("device_idle_pct.f32_chained")(ctx) == pytest.approx(50)
    assert bench.reader("device_idle_pct.sync") is bench.reader(
        "device_idle_pct.batch")
