"""``benchmarks/h100/host_share.py`` on synthetic profiler traces.

A trace's kernel timestamps are on the card's clock, converted to the
host's; the conversion can drift by hundreds of µs within one trace. The
split finds the rounds by the port's spans (``dip.*``) and must place
each kernel in the round whose launch call started it (the correlation
id), whatever its timestamp says; the device's idle time of a round is
cut by the span the host was in.
"""

from __future__ import annotations

import importlib.util
import json
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _host_share():
    spec = importlib.util.spec_from_file_location(
        "host_share", os.path.join(ROOT, "benchmarks", "h100",
                                   "host_share.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _event(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def _trace(skew: float, rounds: int = 4, cat: str = "cpu_op") -> dict:
    """Two ops of ``rounds`` timed rounds each, every round the port's
    ``op`` span (its ``alloc`` and its ``launch`` span inside, the launch
    call in the latter) and its ``sync`` span; after each op's loop a
    crop launches a copy kernel outside any round. Every kernel's
    timestamp is its launch call's plus 10 µs plus ``skew``. ``cat`` is
    the category the spans' annotations are recorded under."""
    events, t, corr = [], 1000.0, 0

    def kernel(name, launched_at):
        nonlocal corr
        corr += 1
        events.append(_event("cuda_runtime", "cudaLaunchKernel",
                             launched_at, 5.0, correlation=corr))
        events.append(_event("kernel", name, launched_at + 10.0 + skew,
                             18.0, correlation=corr))

    for op in ("copy_u8(uint4 const*)", "pipeline_u8<2>(unsigned char*)"):
        for _ in range(rounds):
            events.append(_event(cat, "dip.op", t, 20.0))
            events.append(_event(cat, "dip.alloc", t + 1.0, 3.0))
            events.append(_event("cpu_op", "aten::empty", t + 1.5, 2.0))
            events.append(_event(cat, "dip.launch", t + 5.0, 12.0))
            kernel(op, t + 8.0)
            events.append(_event(cat, "dip.sync", t + 22.0, 38.0))
            t += 61.0
        kernel("at::native::elementwise_kernel<128, 4>(int)", t + 5.0)
        t += 40.0
    return {"traceEvents": events}


@pytest.mark.parametrize("skew", [-400.0, -60.0, 0.0, 45.0, 120.0])
def test_kernels_follow_their_launch_not_their_clock(tmp_path, skew):
    host_share = _host_share()
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(_trace(skew)))
    rows = host_share.split(str(path))
    assert [r["kernel"] for r in rows] == ["copy_u8", "pipeline_u8<2>"]
    for r in rows:
        assert r["rounds"] == 3  # four rounds, the last has no next one
        assert r["device"] == 18.0
        assert r["round"] == 61.0
        assert r["harness"] == 1.0
        assert r["wrapper"] == 5.0
        assert r["launch"] == 12.0
        assert r["alloc"] == 3.0
        assert r["sync_wait"] + r["sync_own"] == 38.0


def test_rounds_without_a_kernel_launch_are_left_out(tmp_path):
    host_share = _host_share()
    trace = _trace(0.0)
    trace["traceEvents"] = [e for e in trace["traceEvents"]
                            if not (e["cat"] == "cuda_runtime"
                                    and e["args"]["correlation"] == 1)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(trace))
    rounds = host_share.rounds(json.loads(path.read_text()))
    assert [r["kernel"] for r in rounds] == (["copy_u8"] * 3
                                             + ["pipeline_u8<2>"] * 4)


@pytest.mark.parametrize("skew", [-400.0, 0.0, 45.0])
def test_clock_skew_reads_the_conversion_error(skew):
    host_share = _host_share()
    low, median, high = host_share.clock_skew(_trace(skew))
    assert low == median == high == 10.0 + skew


def test_command_line_prints_the_split(tmp_path, capsys):
    host_share = _host_share()
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(_trace(-400.0)))
    assert host_share.main([str(path)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].endswith("-390.0, -390.0, -390.0")
    assert [ln.split(" | ")[0] for ln in out[2:4]] == ["| copy_u8",
                                                        "| pipeline_u8<2>"]
    assert out[6].startswith("| copy_u8 | 43.0 | ")
    assert [r["kernel"] for r in json.loads(out[8])] == ["copy_u8",
                                                         "pipeline_u8<2>"]
    assert host_share.main([]) == 2


@pytest.mark.parametrize("cat", ["cpu_op", "user_annotation"])
def test_idle_by_span_cuts_each_gap_by_the_innermost_span(tmp_path, cat):
    """A round is 61 µs with its kernel busy 18 of them (from 18 µs in):
    the gap before the kernel goes to the op span, its alloc and its
    launch; the one after to the sync span, then 1 µs of harness."""
    host_share = _host_share()
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(_trace(0.0, cat=cat)))
    for r in host_share.split(str(path)):
        assert r["idle_us"] == 43.0
        assert r["idle_by_span"] == {
            "op": 3.0, "alloc": 3.0, "launch": 12.0, "sync": 24.0,
            host_share.OUTSIDE: 1.0}


@pytest.mark.parametrize("skew", [-400.0, -60.0, -5.0, 45.0, 120.0])
def test_idle_by_span_parts_sum_to_the_idle_time(skew):
    """Whatever the clocks say, the parts of a round's idle time sum to
    the round less the device's busy time in it."""
    host_share = _host_share()
    trace = _trace(skew)
    device = [(e["ts"], e["ts"] + e["dur"]) for e in trace["traceEvents"]
              if e["cat"] == "kernel"]
    rounds = [r for r in host_share.rounds(trace)
              if r["idle_by_span"] is not None]
    assert len(rounds) == 6
    for r in rounds:
        t0, t1 = r["ts"], r["ts"] + r["round"]
        busy = sum(max(0.0, min(b, t1) - max(a, t0)) for a, b in device)
        assert r["busy"] == pytest.approx(busy)
        assert sum(r["idle_by_span"].values()) == pytest.approx(
            r["round"] - busy)
