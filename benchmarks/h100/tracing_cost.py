#!/usr/bin/env python3
"""What the port's spans (``runtime/tracing.py``) cost, off and on, and how
far the profiler stretches them, on one GPU.

    python3 benchmarks/h100/tracing_cost.py --parent DIR [--pairs 3] \\
        [--seconds 10] [--window 8] [--inproc 60] \\
        [--cells fundus-u8.sync,...]

``DIR`` is a checkout of the commit before the spans (``git archive``),
in a folder that git ignores. Four parts, each printed as it ends:

- ``sites``: ns a call of the three forms of a span site (the inline
  test of the flags, ``call``, ``with span()``), off (no ``enable()``, no
  profiler) against the bare call, on with ``enable()``, and under
  ``torch.profiler`` (CPU and CUDA activity), beside the
  profiler annotations the tracer can use (``_RecordFunctionFast``,
  ``record_function``, ``_record_function_with_args_enter``);
- ``window``: the ``fundus-u8.sync`` traffic (``dipbench/drivers/
  rounds.py``, the full-size seeded fundus) for ``--window`` seconds with
  ``enable()`` and the benchmark's own span around the same ``OPS`` calls
  (``dipbench/drive.Spans``, what ``enqueue_us.sync`` reads): every
  span's mean, and ``op``'s mean against the outside span's; then the
  traced sub-window's 2600 rounds under the profiler, as ``dipbench/
  drive.traced`` runs them: each span's mean there over its mean with
  ``enable()``, the profiler's stretch. The same for ``fundus-u8.batch``
  (its window, then its three traced batches; ``batch``'s self share);
- ``inproc``: the sync traffic's rounds of the parent's port and of this
  tree's (each imported under a name of its own), two sessions in one
  process, one cycle of the 13 rows each in turn for ``--inproc``
  seconds: each side's mean ``round_us`` and the median ratio of a
  cycle of this tree's to the parent's next to it, which the host's
  drift does not blur;
- ``ab``: ``dipbench/run.py --workload <cell> --trace 0`` for each of
  ``--cells`` (``fundus-u8.sync`` first), ``--seconds`` a run, in the
  parent and in this tree, in the order parent, this, this, parent,
  ``--pairs`` times, each pair on a seed of its own: the cell's
  end-to-end metric of each run and the median of this tree's over the
  parent's; the sync cell's against the off-cost the ``sites`` part
  predicts (the sites a round passes times their off ns).

Prints the ``nvidia-smi`` name and power limit first and one JSON object
with every number last, also written to ``chiprun_out/tracing_cost.json``.
Needs a CUDA device; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.normpath(os.path.join(HERE, "..", ".."))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from dip_benchmark_tpu_torch.runtime import tracing  # noqa: E402

OUT = os.path.join(ROOT, "chiprun_out", "tracing_cost.json")
SEED = 4200000017
ROUND_SITES = ("op", "alloc", "launch", "sync")


def smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def per_call_ns(loop, n: int, reps: int = 7) -> float:
    """The least ns a call of ``loop(n)`` over ``reps`` repetitions."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter_ns()
        loop(n)
        best = min(best, (time.perf_counter_ns() - t0) / n)
    return best


def _f(x):
    return x


def _bare(n):
    for _ in range(n):
        _f(1)


def _g(x):
    return _f(x)


def _frame(n):
    for _ in range(n):
        _g(1)


def _inline(n):
    for _ in range(n):
        if tracing.enabled or tracing.profiler._is_profiler_enabled:
            tracing.call("op", _f, 1)
        else:
            _f(1)


def _call(n):
    call = tracing.call
    for _ in range(n):
        call("op", _f, 1)


def _span(n):
    span = tracing.span
    for _ in range(n):
        with span("op"):
            _f(1)


def sites(n: int = 200_000) -> dict:
    """ns a call of each site form beyond the bare call, off, enabled and
    profiled, and of each annotation under the profiler."""
    out = {"bare_ns": per_call_ns(_bare, n)}
    # One more Python frame, for scale.
    out["frame_ns"] = per_call_ns(_frame, n) - out["bare_ns"]
    for mode in ("off", "enabled", "profiled"):
        m = n if mode == "off" else n // 10
        if mode == "enabled":
            tracing.enable()
        prof = (profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA])
                if mode == "profiled" else None)
        if prof is not None:
            prof.__enter__()
        bare = per_call_ns(_bare, m)
        out[f"inline_{mode}_ns"] = per_call_ns(_inline, m) - bare
        out[f"call_{mode}_ns"] = per_call_ns(_call, m) - bare
        out[f"span_{mode}_ns"] = per_call_ns(_span, m) - bare
        if prof is not None:
            rff = torch._C._profiler._RecordFunctionFast
            rf = torch.autograd.profiler.record_function
            ag = torch._C._autograd

            def fast(k):
                for _ in range(k):
                    with rff("dip.x"):
                        pass

            def slow(k):
                for _ in range(k):
                    with rf("dip.x"):
                        pass

            def args(k):
                for _ in range(k):
                    ag._record_function_with_args_exit(
                        ag._record_function_with_args_enter("dip.x"))
            m2 = m // 4
            out["annotation_ns"] = {
                "_RecordFunctionFast": per_call_ns(fast, m2, 3),
                "record_function": per_call_ns(slow, m2, 3),
                "_record_function_with_args": per_call_ns(args, m2, 3)}
            prof.__exit__(None, None, None)
        tracing.disable()
    tracing.reset()
    return out


def _means(snap) -> dict:
    return {k: {"calls": c, "mean_us": t / c / 1e3, "self_us": s / c / 1e3}
            for k, (c, t, s) in snap.spans.items() if c}


def window(seconds: float) -> dict:
    """The sync traffic with enable() and the outside span, then its
    traced sub-window; three batches likewise."""
    from dipbench import drive
    from dipbench.drivers import batch as batch_traffic
    from dipbench.drivers import rounds
    from dipbench.run import Bench

    bench = Bench(ROOT)
    dev = torch.device("cuda", 0)
    out = {}
    for name, traffic in (("fundus-u8.sync", rounds),
                          ("fundus-u8.batch", batch_traffic)):
        cell = bench.cell(name)
        cfg, mix = bench.config(cell), bench.mix(cell)
        inputs = traffic.make_inputs(cfg, mix, SEED, dev)
        spans = drive.Spans()
        driver = traffic.Driver(cfg, mix, inputs, SEED, dev, spans)
        drive.warm(driver, int(mix.get("warmup", 1)))
        torch.cuda.synchronize(dev)
        spans.on = True
        tracing.enable()
        _, win = drive.measure(driver, seconds)
        tracing.disable()
        spans.on = False
        enabled = _means(tracing.snapshot())
        row = {"rounds": win.rounds, "seconds": win.seconds,
               "enabled": enabled, "counters": dict(
                   tracing.snapshot().counters)}
        if spans.enqueue_calls:
            outside = spans.enqueue_ns / spans.enqueue_calls / 1e3
            row["outside_us"] = outside
            row["op_over_outside"] = enabled["op"]["mean_us"] / outside
        path = os.path.join(ROOT, "build", "tracing_cost_trace.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        drive.traced(driver, int(mix["trace_rounds"]), path)
        os.remove(path)
        profiled = _means(tracing.snapshot())
        row["profiled"] = profiled
        row["stretch"] = {k: profiled[k]["mean_us"] / v["mean_us"]
                          for k, v in enabled.items() if k in profiled}
        if "batch" in enabled:
            for key, spans_ in (("enabled", enabled), ("profiled", profiled)):
                b = spans_["batch"]
                row[f"batch_self_share_{key}"] = b["self_us"] / b["mean_us"]
        driver.close()
        out[name] = row
        print(f"[window] {name}: {json.dumps(row)}", flush=True)
    return out


def ab(parent: str, cell: str, pairs: int, seconds: float) -> dict:
    """The cell's end-to-end metric (other than ``setup_s``), parent and
    this tree alternated."""
    from dipbench.run import Bench
    bench = Bench(ROOT)
    metric = next(m for m in bench.end_to_end(bench.cell(cell))
                  if m["name"] != "setup_s")
    name = metric["name"]
    runs = []
    for p in range(pairs):
        seed = SEED + 7919 * (p + 1)
        for side in ("parent", "change", "change", "parent"):
            cwd = parent if side == "parent" else ROOT
            proc = subprocess.run(
                [sys.executable, "dipbench/run.py", "--workload", cell,
                 "--seed", str(seed), "--seconds", str(seconds), "--trace",
                 "0"], cwd=cwd, capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                raise RuntimeError(f"{side} run failed:\n{proc.stderr}")
            result = json.loads(proc.stdout.strip().splitlines()[-1])
            value = result["metrics"][name]["value"]
            runs.append({"pair": p, "side": side, "seed": seed,
                         name: value, "correct": result["correct"]})
            print(f"[ab] {cell} pair {p} {side}: {name} {value} correct "
                  f"{result['correct']}", flush=True)
    med = {s: statistics.median(r[name] for r in runs if r["side"] == s)
           for s in ("parent", "change")}
    ratios = []
    for p in range(pairs):
        side = {s: statistics.mean(r[name] for r in runs
                                   if r["pair"] == p and r["side"] == s)
                for s in ("parent", "change")}
        ratios.append(side["change"] / side["parent"])
    return {"metric": name, "better": metric["better"], "runs": runs,
            "median": med,
            "change_over_parent_median": med["change"] / med["parent"],
            "pair_ratios": ratios}


def inproc(trees: dict, seconds: float, device=None, size=None) -> dict:
    """The sync traffic's rounds in one process, a session of each tree's
    port (``trees``: side name -> checkout, each port imported under a
    name of its own) over the same image, one cycle of the 13 rows of
    each side in turn, the side that goes first rotating, for
    ``seconds``: the host's drift falls on every side alike. Each side's
    mean ``round_us``, and each side's median ratio to the first side's
    over the turns. ``device`` and ``size`` (H, W) replace the card and
    the configuration's image (tests on the CPU)."""
    import importlib
    import tempfile

    from dipbench.drivers import rounds
    from dipbench.run import Bench

    links = tempfile.mkdtemp()
    sys.path.insert(0, links)
    bench = Bench(ROOT)
    cell = bench.cell("fundus-u8.sync")
    cfg, mix = bench.config(cell), bench.mix(cell)
    dev = device or torch.device("cuda", 0)
    inputs = rounds.make_inputs(cfg, mix, SEED, dev, size)
    names = rounds.row_names(mix)
    runs = {}
    for side, tree in trees.items():
        package = f"dip_port_{side}"
        os.symlink(os.path.join(os.path.abspath(tree),
                                "dip_benchmark_tpu_torch"),
                   os.path.join(links, package))
        module = importlib.import_module(package + ".session")
        session = module.BenchmarkSession(inputs, dev, dtype="uint8",
                                          path="kernel")
        by_col = {op.csv_column: op.run for op in session.operations(True)}
        runs[side] = [by_col[n] for n in names]
        for _ in range(int(mix.get("warmup", 1))):
            for run in runs[side]:
                run()
    sides = list(trees)
    ns: dict[str, list[int]] = {side: [] for side in sides}
    clock = time.perf_counter_ns
    t_end = time.perf_counter() + seconds
    turn = 0
    while time.perf_counter() < t_end:
        k = turn % len(sides)
        for side in sides[k:] + sides[:k]:
            ops = runs[side]
            t0 = clock()
            for run in ops:
                run()
            ns[side].append(clock() - t0)
        turn += 1
    n = len(names)
    out = {"turns": turn, "round_us": {
        side: sum(v) / len(v) / n / 1e3 for side, v in ns.items()}}
    first = sides[0]
    for side in sides[1:]:
        ratios = [c / p for c, p in zip(ns[side], ns[first])]
        out[f"{side}_over_{first}"] = {
            "median": statistics.median(ratios),
            "quartiles": statistics.quantiles(ratios, n=4),
            "slower_share": sum(r > 1 for r in ratios) / len(ratios),
            "mean_us_difference": out["round_us"][side]
            - out["round_us"][first]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--window", type=float, default=8.0)
    ap.add_argument("--inproc", type=float, default=60.0,
                    help="seconds of the in-process A/B (0: none)")
    ap.add_argument("--cells", default="fundus-u8.sync",
                    help="the cells of the ab part, comma-separated; the "
                         "first is fundus-u8.sync")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tracing_cost: no CUDA device", file=sys.stderr)
        return 1
    out = {"nvidia_smi": smi(), "torch": torch.__version__}
    print(f"[device] {out['nvidia_smi']} | torch {out['torch']}",
          flush=True)
    out["sites"] = sites()
    print(f"[sites] {json.dumps(out['sites'])}", flush=True)
    out["window"] = window(args.window)
    sync = out["window"]["fundus-u8.sync"]
    per_round = {k: sync["enabled"][k]["calls"] / sync["rounds"]
                 for k in ROUND_SITES if k in sync["enabled"]}
    # The op, launch and sync sites test the flags inline; the alloc site
    # is a call.
    inline = sum(per_round.get(k, 0) for k in ("op", "launch", "sync"))
    calls = per_round.get("alloc", 0)
    site = out["sites"]
    out["off_us_a_round"] = (inline * site["inline_off_ns"]
                             + calls * site["call_off_ns"]) / 1e3
    print(f"[off] {per_round} sites a round: {inline:.0f} inline x "
          f"{site['inline_off_ns']:.1f} ns + {calls:.0f} calls x "
          f"{site['call_off_ns']:.1f} = {out['off_us_a_round']:.3f} µs a "
          f"round", flush=True)
    if args.inproc:
        got = out["inproc"] = inproc(
            {"parent": os.path.abspath(args.parent), "change": ROOT},
            args.inproc)
        print(f"[inproc] {json.dumps(got)}", flush=True)
    out["ab"] = {}
    for cell in args.cells.split(","):
        got = out["ab"][cell] = ab(os.path.abspath(args.parent), cell,
                                   args.pairs, args.seconds)
        print(f"[ab] {cell} {got['metric']} medians {got['median']}, "
              f"change / parent {got['change_over_parent_median']:.4f}, "
              f"pairs {got['pair_ratios']}", flush=True)
    out["off_share_of_round"] = (
        out["off_us_a_round"]
        / out["ab"]["fundus-u8.sync"]["median"]["parent"])
    print(f"[off] predicted off-cost {100 * out['off_share_of_round']:.2f} "
          f"% of the parent's median round_us", flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
