#!/usr/bin/env python3
"""The control of a cell's check: the reference put in the program's
place, computed in the precision below the configuration's own (int16
sums for the uint8 model's int32, bfloat16 for float32), judged by the
check exactly as a run judges the program. It has to come out as not
correct.

    python3 dipbench/control.py --workload <cell> --seeds 1,2,3

prints, for each seed, the control's numbers beside the cell's limits,
then one JSON line. It runs on the card at the configuration's size. The
outputs are a function of the inputs alone, so no measured window runs:
each seed's inputs are made as a run makes them, and the control's
outputs take the names and shapes the program's have
(``output_shapes`` of the cell's driver).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from dipbench import check  # noqa: E402
from dipbench.run import Bench  # noqa: E402


def readings(bench: Bench, name: str, seed: int, device,
             size=None) -> dict:
    """The check's numbers for the control of cell ``name`` on ``seed``;
    ``size`` (H, W) replaces the configuration's (tests on the CPU)."""
    cell = bench.cell(name)
    cfg, mix, limits = bench.config(cell), bench.mix(cell), bench.limits(cell)
    traffic = bench.driver(mix)
    inputs = traffic.make_inputs(cfg, mix, seed, device, size)
    shapes = traffic.output_shapes(cfg, mix, inputs)
    want = traffic.expected(cfg, mix, inputs, shapes, cfg["precision"],
                            device)
    low = traffic.expected(cfg, mix, inputs, shapes,
                           cfg["control_precision"], device)
    got = {n: low[check.base(n)][0] for n in shapes}
    gaps = check.compare(cfg["dtype"], got, want)
    return {"seed": seed, "level_gap": max(gaps.values()),
            "limit": limits["level_gap"], "gaps": gaps}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    bench = Bench()
    out = []
    for seed in (int(s) for s in args.seeds.split(",")):
        r = readings(bench, args.workload, seed, torch.device("cuda"))
        print(f"{args.workload} seed {seed}: control level_gap "
              f"{r['level_gap']} (limit {r['limit']}); by output "
              f"{r['gaps']}", file=sys.stderr)
        out.append(r)
    print(json.dumps({"workload": args.workload, "readings": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
