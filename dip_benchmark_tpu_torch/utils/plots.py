"""Reporting: grouped log-scale bar charts from a results.csv.

The port's own copy of ``dip_benchmark_tpu/utils/plots.py``, a peer of the
reference's plot.py: the same input schema (``Tool,<14 op columns>``,
seconds a round; empty cells for ops a partial run such as ``--chained``
did not cover), the same five operation groups, one horizontal grouped bar
chart per group on a log x-axis labelled in microseconds, and the
execution chart from a bench JSON's per-op ``exec_us``. matplotlib is
imported inside the renderers, so the package imports without it.

    python -m dip_benchmark_tpu_torch.utils.plots results.csv outdir \\
        [--exec-json BENCH_JSON]
"""

from __future__ import annotations

import csv
import os
import sys

OP_GROUPS = {
    "memory-operations": ["Upload", "Download", "Copy"],
    "point-operations": ["Inversion", "Grayscale", "Threshold"],
    "erosion-operations": ["Erosion-3x3-Cross", "Erosion-3x3-Square",
                           "Erosion-1x3+3x1-Square"],
    "convolution-3x3-operations": ["Convolution-3x3", "Convolution-1x3+3x1",
                                   "Gaussian-Blur-3x3"],
    "convolution-5x5-operations": ["Convolution-5x5", "Convolution-1x5+5x1"],
}

# The port's own CSV tool names (``cli.default_tool``): left out of the
# execution chart's reference bars, which its device-time bar replaces.
PORT_TOOLS = ("H100-cuda", "H100-torch", "CPU-torch", "CPU-torch-library")


def read_results(csv_path: str) -> tuple[list[str], dict[str, list]]:
    """Return (tools, {op_column: [seconds-or-None per tool]}). Empty or
    missing cells are legitimate (csv_row writes '' for ops a partial run
    — e.g. --chained — didn't cover); they parse to None and the
    renderers skip those bars."""
    with open(csv_path) as f:
        rows = list(csv.DictReader(f))

    def _parse(v):
        try:
            return float(v)
        except (TypeError, ValueError):
            return None

    tools = [r["Tool"] for r in rows]
    columns = [c for c in rows[0].keys() if c != "Tool"]
    data = {c: [_parse(r.get(c)) for r in rows] for c in columns}
    return tools, data


def render_group_charts(csv_path: str, outdir: str) -> list[str]:
    """Write one PNG per op group; returns the written paths."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    tools, data = read_results(csv_path)
    os.makedirs(outdir, exist_ok=True)
    written = []
    colors = plt.colormaps["tab10"](np.linspace(0, 1, max(len(tools), 3)))
    for name, ops in OP_GROUPS.items():
        ops = [op for op in ops if op in data]
        if not ops:
            continue
        fig, ax = plt.subplots(figsize=(11, 1.2 + 1.1 * len(ops)))
        ys = np.arange(len(ops), dtype=float)
        bar_h = 0.8 / len(tools)
        for t, tool in enumerate(tools):
            vals_us = [data[op][t] * 1e6 if data[op][t] is not None
                       else float("nan") for op in ops]
            ax.barh(ys + t * bar_h, vals_us, bar_h, label=tool,
                    color=colors[t])
            for y, v in zip(ys + t * bar_h, vals_us):
                if v > 0:
                    ax.text(v * 1.05, y, f"{v:.0f}", va="center", fontsize=7)
        ax.set_yticks(ys + 0.4 - bar_h / 2)
        ax.set_yticklabels(ops)
        ax.set_xscale("log")
        ax.set_xlabel("time per round (µs, log scale)")
        ax.set_title(name.replace("-", " "))
        ax.legend(loc="lower right", fontsize=8)
        ax.grid(axis="x", alpha=0.3)
        fig.tight_layout()
        path = os.path.join(outdir, f"{name}.png")
        fig.savefig(path, dpi=150)
        plt.close(fig)
        written.append(path)
    return written


def render_exec_chart(csv_path: str, bench_json_path: str,
                      outpath: str) -> str:
    """The reference tools' per-round seconds (async dispatch for several
    of them, so partly enqueue time) against this port's device execution
    time per application (``exec_us`` from a bench JSON, the slope of
    ``--exec``). One log-x bar chart over the 12 on-device ops; the
    port's own CSV rows (``PORT_TOOLS``) are left out, its bar replaces
    them."""
    import json

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    tools, data = read_results(csv_path)
    with open(bench_json_path) as f:
        bench = json.load(f)
    # Strict schema: a bench JSON (top-level "ops") or a record that
    # wraps one under "parsed". Anything else is a caller error that
    # must fail loudly, not render an empty chart.
    ops_json = (bench["parsed"] if "parsed" in bench else bench)["ops"]
    exec_us = {col: d["exec_us"] for col, d in ops_json.items()
               if isinstance(d, dict) and d.get("exec_us")}
    if not exec_us:
        raise ValueError(f"{bench_json_path} has no per-op exec_us rows")
    ops = [op for op in data
           if op not in ("Upload", "Download") and op in exec_us]
    dropped = [op for op in data
               if op not in ("Upload", "Download") and op not in exec_us]
    if dropped:
        # An op without a resolved exec_us must not silently shrink the
        # 12-op chart.
        print(f"NOTE: no exec_us for {', '.join(dropped)} — omitted from "
              f"{outpath}", file=sys.stderr)
    ref_tools = [t for t in tools if t not in PORT_TOOLS]

    fig, ax = plt.subplots(figsize=(11, 1.5 + 0.75 * len(ops)))
    ys = np.arange(len(ops), dtype=float)
    nbars = len(ref_tools) + 1
    bar_h = 0.8 / nbars
    colors = plt.colormaps["tab10"](np.linspace(0, 1, max(nbars, 3)))
    for t, tool in enumerate(ref_tools):
        ti = tools.index(tool)
        vals = [data[op][ti] * 1e6 if data[op][ti] is not None
                else float("nan") for op in ops]
        ax.barh(ys + t * bar_h, vals, bar_h,
                label=f"{tool} (per-round, partly async)", color=colors[t])
    vals = [exec_us[op] for op in ops]
    ax.barh(ys + len(ref_tools) * bar_h, vals, bar_h,
            label="this port (device execution time per application)",
            color="black")
    for y, v in zip(ys + len(ref_tools) * bar_h, vals):
        ax.text(v * 1.08, y, f"{v:.0f}", va="center", fontsize=7)
    ax.set_yticks(ys + 0.4 - bar_h / 2)
    ax.set_yticklabels(ops, fontsize=8)
    ax.set_xscale("log")
    ax.set_xlabel("µs per application (log scale)")
    ax.set_title("reference per-round time vs device execution time")
    ax.legend(loc="lower right", fontsize=7)
    ax.grid(axis="x", alpha=0.3)
    fig.tight_layout()
    fig.savefig(outpath, dpi=150)
    plt.close(fig)
    return outpath


def main(argv: list[str] | None = None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        description="Render grouped benchmark charts from a results.csv")
    p.add_argument("csv", help="results.csv path (reference schema)")
    p.add_argument("outdir", nargs="?", default=".",
                   help="output directory for PNGs")
    p.add_argument("--exec-json", default=None, metavar="BENCH_JSON",
                   help="also render the exec-vs-reference chart from a "
                        "bench JSON's per-op exec_us rows")
    args = p.parse_args(argv)
    for path in render_group_charts(args.csv, args.outdir):
        print(f"Saved plot: {path}")
    if args.exec_json:
        path = render_exec_chart(
            args.csv, args.exec_json,
            os.path.join(args.outdir, "execution-comparison.png"))
        print(f"Saved plot: {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
