#!/usr/bin/env python3
"""H100 backend for the dip-benchmark suite (PyTorch + hand-written CUDA).

Usage (identical contract to the other backends):
    python benchmark.py <infile> <outdir> [--rounds N] [--verify]
        [--pipeline] [--dtype uint8|float32]

Implementation lives in the dip_benchmark_tpu_torch package at the repo root.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from dip_benchmark_tpu_torch.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
