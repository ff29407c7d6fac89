"""``benchmarks/h100/host_share.py`` on synthetic profiler traces.

A trace's kernel timestamps are on the card's clock, converted to the
host's; the conversion can drift by hundreds of µs within one trace. The
split must place each kernel in the round whose launch call started it
(the correlation id), whatever its timestamp says.
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


def _trace(skew: float, rounds: int = 4) -> dict:
    """Two ops of ``rounds`` timed rounds each, every round one run call
    that launches one kernel and synchronizes; after each op's loop a
    crop launches a copy kernel outside any round. Every kernel's
    timestamp is its launch call's plus 10 µs plus ``skew``."""
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
            events.append(_event("python_function",
                                 "dip_benchmark_tpu_torch/session.py(153): "
                                 "run", t, 60.0))
            events.append(_event("python_function",
                                 "dip_benchmark_tpu_torch/ops/kernels/"
                                 "__init__.py(80): launch", t + 5.0, 12.0))
            kernel(op, t + 8.0)
            events.append(_event("cpu_op", "aten::empty", t + 1.0, 3.0))
            events.append(_event("python_function",
                                 "dip_benchmark_tpu_torch/runtime/"
                                 "device.py(30): synchronize", t + 20.0,
                                 38.0))
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
    assert [r["kernel"] for r in json.loads(out[4])] == ["copy_u8",
                                                         "pipeline_u8<2>"]
    assert host_share.main([]) == 2
