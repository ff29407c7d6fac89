#!/usr/bin/env python3
"""The CLI's per-row times of two checkouts of the port, in turns, on one GPU.

    python3 benchmarks/h100/compare_cli.py <checkout A> <checkout B> \\
        [--rounds N] [--turns T]

Runs ``python -m dip_benchmark_tpu_torch.cli <image> <outdir> --rounds N
--pipeline`` (the uint8 model) from each checkout on the same 3504x2336
benchmark image (``utils.testimage.resolve_image``, saved once as PNG), in
the order A, B, B, A, repeated T times, so that a drift of the card or the
host hits both alike. Each run builds its checkout's kernels first (untimed: the
session loads the library before the table). Prints, for every row of the
table, each run's time per round in µs and the median of each checkout,
then the ``nvidia-smi`` name and power limit, and last one JSON object
with every reading. Needs a CUDA device; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from dip_benchmark_tpu_torch.utils.image import save_image  # noqa: E402
from dip_benchmark_tpu_torch.utils.testimage import resolve_image  # noqa: E402

ROW = re.compile(r"^\| (.+?)\s+\|\s+[\d.]+s \(once\) \|\s+([\d.]+)s \(")


def run_cli(checkout: str, image: str, outdir: str,
            rounds: int) -> dict[str, float]:
    """One CLI run from ``checkout``: row description -> µs per round."""
    cmd = [sys.executable, "-m", "dip_benchmark_tpu_torch.cli", image,
           outdir, "--rounds", str(rounds), "--pipeline"]
    env = {**os.environ, "PYTHONPATH": os.path.abspath(checkout)}
    proc = subprocess.run(cmd, cwd=checkout, env=env, capture_output=True,
                          text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{checkout}: exit {proc.returncode}\n"
                           f"{proc.stderr[-4000:]}")
    rows = {}
    for line in proc.stdout.splitlines():
        m = ROW.match(line)
        if m:
            rows[m[1].strip()] = 1e6 * float(m[2])
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_cli: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    img, label = resolve_image()
    readings: dict[str, list[dict]] = {"a": [], "b": []}
    with tempfile.TemporaryDirectory() as tmp:
        image = os.path.join(tmp, "benchmark-image.png")
        save_image(image, img)
        for _ in range(args.turns):
            for which in ("a", "b", "b", "a"):
                readings[which].append(run_cli(
                    getattr(args, which), image, os.path.join(tmp, "out"),
                    args.rounds))
    print(f"{label} uint8 | {smi} | --rounds {args.rounds}, "
          f"{args.turns} turns of A B B A | µs per round")
    medians = {}
    for row in readings["a"][0]:
        a = [r[row] for r in readings["a"]]
        b = [r[row] for r in readings["b"]]
        medians[row] = {"a": statistics.median(a), "b": statistics.median(b)}
        print(f"  {row:50s} A {' '.join(f'{v:8.1f}' for v in a)} | "
              f"B {' '.join(f'{v:8.1f}' for v in b)} | median A "
              f"{medians[row]['a']:8.1f} B {medians[row]['b']:8.1f}")
    print(smi)
    print(json.dumps({"image": label, "nvidia_smi": smi,
                      "rounds": args.rounds, "a": args.a, "b": args.b,
                      "readings": readings, "medians": medians}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
