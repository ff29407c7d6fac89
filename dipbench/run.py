#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 dipbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``, this
folder and the port (``dip_benchmark_tpu_torch``). The cell is the entry
of ``BENCHMARK.json``'s ``workloads``; its configuration, traffic mix and
limits are the files named after them: ``dipbench/configs/<config>.json``,
``dipbench/mixes/<traffic>.json`` and ``dipbench/workloads/<cell>.json``.
The run makes its inputs from ``--seed`` on the card, builds the port's
session or batch path (the kernel library builds at the first run in a
checkout), warms up every row the cell runs, measures for ``--seconds``,
and then judges what the timed path produced against the plain reference
(``dipbench/check.py``). With ``--trace 0`` the result line carries the
cell's end-to-end metrics; with ``--trace 1`` its per-layer metrics, read
by ``dipbench/metrics/<quantity>.py`` (the metric's name up to its first
dot) from the benchmark's spans and from a ``torch.profiler`` trace of a
short sub-window after the measured one. The mix's ``driver`` names the
module that drives the port, ``dipbench/drivers/<driver>.py``.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown`` (traced
runs only) and ``check`` (each number compared with its limit). The same
numbers end standard error. Exit codes: 0 with a result; 2 bad
arguments; 3 no CUDA device, or fewer than the cell needs; 4 a module of
JAX or of the JAX package was loaded; 5 the port is not in the checkout.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "dip_benchmark_tpu")


def process_age() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - started


# The process's age at a known reading of the host clock, taken before
# anything heavy is imported: set-up is measured from the process's start.
_AGE0, _CLOCK0 = process_age(), time.perf_counter()


class Bench:
    """``BENCHMARK.json`` and the data files it names."""

    def __init__(self, root: str = ROOT):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.spec = json.load(f)

    def _file(self, *parts: str) -> dict:
        with open(os.path.join(self.root, "dipbench", *parts)) as f:
            return json.load(f)

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell: dict) -> dict:
        return self._file("configs", cell["config"] + ".json")

    def mix(self, cell: dict) -> dict:
        return self._file("mixes", cell["traffic"] + ".json")

    def limits(self, cell: dict) -> dict:
        return self._file("workloads", cell["name"] + ".json")["limits"]

    def end_to_end(self, cell: dict) -> list[dict]:
        return [m for m in self.spec["end_to_end"]
                if cell["name"] in m.get("workloads", [cell["name"]])]

    def per_layer(self, cell: dict) -> list[dict]:
        """The per-layer metrics that list the cell under ``workloads``."""
        return [m for m in self.spec["per_layer"]
                if cell["name"] in m.get("workloads", [])]

    def _module(self, folder: str, name: str):
        """``dipbench/<folder>/<name>.py`` of this checkout, loaded once."""
        path = os.path.join(self.root, "dipbench", folder, name + ".py")
        key = "dipbench_file:" + os.path.realpath(path)
        if key not in sys.modules:
            spec = importlib.util.spec_from_file_location(key, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            sys.modules[key] = mod
        return sys.modules[key]

    def driver(self, mix: dict):
        """The module ``dipbench/drivers/<driver>.py`` the mix names."""
        return self._module("drivers", mix["driver"])

    def reader(self, metric: str):
        """The ``read(ctx)`` function of the metric's quantity,
        ``dipbench/metrics/<quantity>.py``: ``device_idle_pct.sync`` is read
        by ``device_idle_pct.py``."""
        return self._module("metrics", metric.split(".")[0]).read


class Context:
    """What a per-layer reader reads: the cell, its configuration and mix,
    the trace summary of the sub-window (None without one), the
    benchmark's spans and the measured window (``drive.Window``)."""

    def __init__(self, cell, cfg, mix, trace, spans, window=None):
        self.cell, self.cfg, self.mix = cell, cfg, mix
        self.trace, self.spans, self.window = trace, spans, window


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def device_info(device) -> dict:
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run_cell(bench: Bench, name: str, seed: int, seconds: float,
             trace: bool, device, size=None,
             log=lambda s: print(s, file=sys.stderr)) -> dict:
    """One run of cell ``name``; returns the result object. ``size`` (H, W)
    replaces the configuration's image size (tests on the CPU)."""
    import torch

    from dipbench import check, drive
    from dipbench import trace as trace_mod

    cell = bench.cell(name)
    cfg, mix, limits = bench.config(cell), bench.mix(cell), bench.limits(cell)
    traffic = bench.driver(mix)
    spans = drive.Spans() if trace else None
    t = [time.perf_counter()]
    inputs = traffic.make_inputs(cfg, mix, seed, device, size)
    t.append(time.perf_counter())
    driver = traffic.Driver(cfg, mix, inputs, seed, device, spans)
    t.append(time.perf_counter())
    drive.warm(driver, int(mix.get("warmup", 1)))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t.append(time.perf_counter())
    log(f"set-up: to the cell {_AGE0 + t[0] - _CLOCK0:.3f} s, inputs "
        f"{t[1] - t[0]:.3f} s, session {t[2] - t[1]:.3f} s, warm-up "
        f"{t[3] - t[2]:.3f} s")
    if spans is not None:
        spans.on = True
    t0, window = drive.measure(driver, seconds)
    if spans is not None:
        spans.on = False
    setup_s = _AGE0 + (t0 - _CLOCK0)

    summary = None
    if trace:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            drive.traced(driver, int(mix["trace_rounds"]), path)
            summary = trace_mod.load(path)
    dev = device_info(device)
    got = driver.outputs()
    driver.close()
    del driver
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # The check, after the window and the memory reading.
    shapes = {n: tuple(out.shape) for n, out in got.items()}
    want = traffic.expected(cfg, mix, inputs, shapes, cfg["precision"],
                            device)
    gaps = check.compare(cfg["dtype"], got, want)
    lost = check.missing(traffic.output_shapes(cfg, mix, inputs), got)
    values = list(gaps.values())
    worst = (float("nan") if not values or any(g != g for g in values)
             else max(values))
    numbers = {"level_gap": {"value": worst, "limit": limits["level_gap"]},
               "outputs_missing": {"value": lost, "limit": 0}}
    correct = all(v["value"] <= v["limit"] for v in numbers.values())
    over = sum(1 for g in gaps.values() if not g <= limits["level_gap"])
    for out_name, g in gaps.items():
        log(f"gap {out_name}: {g}")
    log(f"dontcare_share: {check.dontcare_share(want)}")

    if trace:
        ctx = Context(cell, cfg, mix, summary, spans, window)
        metrics = {}
        for m in bench.per_layer(cell):
            value = bench.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        # A metric is named by its quantity, then optionally by a dot and
        # the cells it is split for: app_us.f32 is an app_us.
        e2e = {"setup_s": setup_s,
               "round_us": 1e6 * window.seconds / window.rounds,
               "app_us": 1e6 * window.seconds / window.items,
               "images_per_s": window.items / window.seconds}
        metrics = {m["name"]: {"value": e2e[m["name"].split(".")[0]],
                               "unit": m["unit"]}
                   for m in bench.end_to_end(cell)}
    result = {"correct": bool(correct), "attempted": window.items,
              "failed": round(window.items * over / max(len(gaps), 1)),
              "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_us * 1e-6
        dev["window_s"] = summary.window_us * 1e-6
        result["breakdown"] = summary.breakdown()
    result["check"] = {k: {"value": _number(v["value"]), "limit": v["limit"]}
                       for k, v in numbers.items()}
    for k, v in numbers.items():
        log(f"{k}: {v['value']} (limit {v['limit']})")
    return result


def _number(v: float):
    """A JSON number, or the name of a value JSON has no number for."""
    return v if v == v and abs(v) != float("inf") else str(v)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    bench = Bench()
    cell = bench.cell(args.workload)
    try:
        import dip_benchmark_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the port is not in this checkout: {e}", file=sys.stderr)
        return 5
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), device)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 4
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
