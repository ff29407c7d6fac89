"""The port's spans and counters (``runtime/tracing.py``) on the CPU: off
they read no clock and record nothing; on, with ``enable()`` or under a
profiler, they nest, time and count; a new recording period clears the
last; the session's rounds and the batch tool record their spans; the
benchmark's readers of them; and ``dipbench/trace.py`` does not see them."""

from __future__ import annotations

import copy
import json
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dip_benchmark_tpu_torch.models import batch
from dip_benchmark_tpu_torch.runtime import tracing
from dip_benchmark_tpu_torch.session import BenchmarkSession

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from dipbench import run, trace  # noqa: E402
from dipbench.metrics import _port  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def off():
    """Every test starts and ends with nothing recording."""
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def scripted_clock(monkeypatch, *readings):
    """Make the span clock return ``readings`` in turn."""
    it = iter(readings)
    monkeypatch.setattr(tracing, "clock", lambda: next(it))


def no_clock(monkeypatch):
    def read():
        raise AssertionError("an off span read the clock")
    monkeypatch.setattr(tracing, "clock", read)


def image(shape=(13, 17, 3), seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


# -- off -----------------------------------------------------------------

def test_off_a_span_is_the_shared_null_and_reads_no_clock(monkeypatch):
    no_clock(monkeypatch)
    assert tracing.span("op") is tracing.span("launch") is tracing._NULL
    with tracing.span("op"):
        with tracing.span("alloc"):
            pass
    assert tracing.call("sync", lambda a: a + 2, 3) == 5
    tracing.count("images", 8)
    snap = tracing.snapshot()
    assert dict(snap.spans) == {} and dict(snap.counters) == {}


def test_off_a_span_passes_exceptions_through(monkeypatch):
    no_clock(monkeypatch)
    with pytest.raises(KeyError):
        with tracing.span("op"):
            raise KeyError("x")
    with pytest.raises(KeyError):
        tracing.call("op", {}.__getitem__, "x")


# -- enable() ------------------------------------------------------------

def test_nested_spans_give_calls_totals_and_self_times(monkeypatch):
    # outer 0..20, inner 10..13 and 14..18; alloc (via call) 15..16 in
    # the second inner.
    scripted_clock(monkeypatch, 0, 10, 13, 14, 15, 16, 18, 20)
    tracing.enable()
    with tracing.span("outer"):
        with tracing.span("inner"):
            pass
        with tracing.span("inner"):
            tracing.call("alloc", len, ())
    tracing.count("images", 3)
    tracing.count("images")
    snap = tracing.snapshot()
    assert dict(snap.spans) == {"outer": (1, 20, 13), "inner": (2, 7, 6),
                                "alloc": (1, 1, 1)}
    assert dict(snap.counters) == {"images": 4}
    with pytest.raises(TypeError):
        snap.spans["outer"] = (0, 0, 0)


def test_a_span_left_by_an_exception_still_records(monkeypatch):
    scripted_clock(monkeypatch, 0, 5, 7, 9)
    tracing.enable()
    with pytest.raises(ValueError):
        with tracing.span("outer"):
            tracing.call("launch", _raise, None)
    assert dict(tracing.snapshot().spans) == {"outer": (1, 9, 7),
                                              "launch": (1, 2, 2)}
    assert tracing._local.stack == []


def _raise(_):
    raise ValueError("refused")


def test_the_snapshot_is_a_copy():
    tracing.enable()
    with tracing.span("op"):
        pass
    snap = tracing.snapshot()
    with tracing.span("op"):
        pass
    assert snap.spans["op"][0] == 1
    assert tracing.snapshot().spans["op"][0] == 2


# -- periods --------------------------------------------------------------

def test_a_new_period_clears_the_last():
    tracing.enable()
    with tracing.span("op"):
        pass
    tracing.disable()
    # Off: the period's sums stay readable.
    with tracing.span("op"):
        pass
    assert tracing.snapshot().spans["op"][0] == 1
    tracing.enable()
    assert dict(tracing.snapshot().spans) == {}
    with tracing.span("sync"):
        pass
    tracing.disable()
    # The first span under a profiler after spans found none starts one.
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("launch"):
            pass
        tracing.count("images", 2)
    assert dict(tracing.snapshot().spans).keys() == {"launch"}
    assert dict(tracing.snapshot().counters) == {"images": 2}
    with tracing.span("op"):        # off again: finds no profiler
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count("images")
    assert dict(tracing.snapshot().spans) == {}
    assert dict(tracing.snapshot().counters) == {"images": 1}


def test_enable_under_a_profiler_keeps_one_period():
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("op"):
            pass
        tracing.enable()
        with tracing.span("op"):
            pass
        tracing.disable()
        with tracing.span("op"):    # the profiler still records
            pass
    assert tracing.snapshot().spans["op"][0] == 2


# -- under the profiler -------------------------------------------------

def test_profiled_spans_are_annotations_nested_as_the_spans(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with tracing.span("outer"):
                tracing.call("inner", torch.empty, 4)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"
              and e.get("name", "").startswith(tracing.PREFIX)]
    assert {e["cat"] for e in events} <= {"cpu_op", "user_annotation"}
    outer = sorted((e for e in events if e["name"] == "dip.outer"),
                   key=lambda e: e["ts"])
    inner = sorted((e for e in events if e["name"] == "dip.inner"),
                   key=lambda e: e["ts"])
    assert len(outer) == len(inner) == 3
    for o, i in zip(outer, inner):
        assert o["ts"] <= i["ts"]
        assert i["ts"] + i["dur"] <= o["ts"] + o["dur"]
    snap = tracing.snapshot()
    assert snap.spans["outer"][0] == snap.spans["inner"][0] == 3
    calls, total, self_ns = snap.spans["outer"]
    assert 0 < self_ns < total


def test_the_annotation_costs_no_span_self_time(monkeypatch):
    # outer: outer0 0, t0 1; inner: outer0 2, t0 3, t1 5, after its
    # annotation 8; outer: t1 10, after 11. The inner's annotation (2..3,
    # 5..8) falls in neither span's self time.
    scripted_clock(monkeypatch, 0, 1, 2, 3, 5, 8, 10, 11)
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("outer"):
            with tracing.span("inner"):
                pass
    snap = tracing.snapshot()
    assert snap.spans["inner"] == (1, 2, 2)
    assert snap.spans["outer"] == (1, 9, 3)


# -- the port's spans ---------------------------------------------------

def test_a_cpu_session_round_records_op_and_sync():
    session = BenchmarkSession(image(), CPU)
    ops = session.operations(include_pipeline=True)
    device_rows = [op for op in ops if op.csv_column not in
                   ("Upload", "Download")]
    tracing.enable()
    for _ in range(2):
        for op in device_rows:
            op.run()
    spans = tracing.snapshot().spans
    assert len(device_rows) == 13
    assert spans["op"][0] == spans["sync"][0] == 26
    # The plain versions on the CPU allocate and launch nothing.
    assert "launch" not in spans and "alloc" not in spans


def test_a_cpu_batch_records_batch_bake_and_crop():
    stack = np.stack([image(seed=s) for s in range(3)])
    tracing.enable()
    out = batch.process_batch(stack, "Fused-Pipeline", device=CPU)
    snap = tracing.snapshot()
    assert out.shape == stack.shape
    assert snap.counters["images"] == 3 and snap.counters["batch_chunks"] == 1
    assert {k: v[0] for k, v in snap.spans.items()} == {
        "batch": 1, "bake": 1, "crop": 1}
    calls, total, self_ns = snap.spans["batch"]
    assert self_ns <= total - snap.spans["bake"][1] - snap.spans["crop"][1]


class _FakeLibrary:
    """A kernel library whose entry points return a status."""

    def __init__(self, status):
        self.status = status

    def dip_ok(self, *args):
        return self.status

    def dip_error_string(self, status):
        return b"refused"


class _FakeStream:
    cuda_stream = 0


@pytest.mark.parametrize("status", [0, 7])
def test_a_launch_is_a_launch_span_refused_or_not(monkeypatch, status):
    from dip_benchmark_tpu_torch.ops import kernels
    monkeypatch.setattr(kernels, "load", lambda: _FakeLibrary(status))
    monkeypatch.setattr(torch.cuda, "device", lambda d: tracing._NULL)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: _FakeStream())
    kernels.reset_launches()
    for on in (False, True):
        if on:
            tracing.enable()
        try:
            kernels.launch("ok_u8", "dip_ok", CPU, 1, 2)
        except kernels.KernelLaunchError:
            assert status
    assert kernels.LAUNCHES == ({} if status else {"ok_u8": 2})
    assert tracing.snapshot().spans["launch"][0] == 1
    assert tracing._local.stack == []


# -- the benchmark's readers --------------------------------------------

SNAP = tracing.Snapshot(
    spans={"op": (10, 300_000, 120_000), "alloc": (10, 50_000, 50_000),
           "launch": (20, 160_000, 160_000), "sync": (10, 210_000, 210_000),
           "batch": (2, 3_000_000_000, 100_000_000),
           "bake": (2, 2_000_000_000, 1_600_000_000),
           "pin_alloc": (4, 400_000_000, 400_000_000),
           "crop": (2, 200_000_000, 200_000_000),
           "fetch": (2, 80_000_000, 80_000_000)},
    counters={"images": 16, "card_bakes": 16, "card_crops": 12,
              "batch_chunks": 16})
WANT = {"wrapper_us.sync": 12.0, "alloc_us.sync": 5.0, "launch_us.sync": 8.0,
        "launches_per_round.sync": 2.0, "sync_wait_us.sync": 21.0,
        "bake_ms.batch": 100.0, "pin_alloc_ms.batch": 25.0,
        "crop_ms.batch": 12.5, "card_bake_share.batch": 100.0,
        "card_crop_share.batch": 75.0, "chunks_per_batch.batch": 8.0,
        "fetch_wait_ms.batch": 5.0}


@pytest.mark.parametrize("metric", sorted(WANT))
def test_each_span_reader_on_a_made_up_snapshot(metric, monkeypatch):
    bench = run.Bench()
    read = bench.reader(metric)
    monkeypatch.setattr(_port, "snapshot", lambda: SNAP)
    assert read(None) == pytest.approx(WANT[metric])
    empty = tracing.Snapshot(spans={k: (0, 0, 0) for k in SNAP.spans},
                             counters={"images": 0})
    monkeypatch.setattr(_port, "snapshot", lambda: empty)
    assert read(None) is None
    monkeypatch.setattr(_port, "snapshot", lambda: None)
    assert read(None) is None


def test_the_readers_find_nothing_in_a_port_without_the_tracer(
        monkeypatch):
    monkeypatch.setitem(sys.modules,
                        "dip_benchmark_tpu_torch.runtime.tracing", None)
    import dip_benchmark_tpu_torch.runtime as runtime
    monkeypatch.delattr(runtime, "tracing")
    assert _port.snapshot() is None
    assert run.Bench().reader("wrapper_us.sync")(None) is None


def test_every_new_metric_is_read_in_its_cell_only():
    bench = run.Bench()
    for m in WANT:
        entry = next(e for e in bench.spec["per_layer"] if e["name"] == m)
        cell = "fundus-u8." + m.split(".")[1]
        assert entry["workloads"] == [cell]
        assert entry["moves"] in [e["name"] for e in
                                  bench.end_to_end(bench.cell(cell))]


# -- dipbench/trace.py ----------------------------------------------------

def _ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


@pytest.mark.parametrize("cat", ["cpu_op", "user_annotation"])
def test_the_summary_is_the_same_with_the_ports_spans_in_the_rounds(cat):
    events = [
        _ev("user_annotation", "dipbench.window", 0, 100),
        _ev("user_annotation", "round:Copy", 0, 40),
        _ev("user_annotation", "round:Grayscale", 50, 45),
        _ev("cuda_runtime", "cudaLaunchKernel", 2, 3, correlation=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 52, 3, correlation=2),
        _ev("kernel", "void dip::copy_u8(unsigned char*)", 10, 20,
            correlation=1),
        _ev("kernel", "void grayscale_u8<3>(int)", 60, 10, correlation=2),
    ]
    spans = [_ev(cat, "dip.op", 1, 6), _ev(cat, "dip.alloc", 1.5, 0.5),
             _ev(cat, "dip.launch", 2, 4), _ev(cat, "dip.sync", 8, 30),
             _ev(cat, "dip.op", 51, 6), _ev(cat, "dip.launch", 52, 4),
             _ev(cat, "dip.sync", 58, 35)]
    plain = trace.summarize({"traceEvents": copy.deepcopy(events)})
    spanned = trace.summarize({"traceEvents": events + spans})
    assert spanned == plain
    assert spanned.breakdown() == plain.breakdown()
