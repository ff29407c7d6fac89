#!/usr/bin/env python3
"""H100 backend for the dip-benchmark suite (PyTorch + hand-written CUDA).

Usage (identical contract to the other backends):
    python benchmark.py <infile> <outdir> [--rounds N] [--verify]
        [--pipeline] [--dtype uint8|float32] [--fuse COL,COL,...]
        [--path kernel|library] [--warm] [--profile DIR]
        [--exec | --chained K] [--shards N] [--backend cuda|cpu]

--path library runs PyTorch library calls instead of the hand-written
kernels; --exec prints each op's device time per application last (the
slope over K of CUDA graphs of K launches, with its spread and L2-warm or
L2-cold); --chained K times K chained applications a round (one CUDA
graph) and reports per application; --warm runs each op once before
timing; --profile DIR writes a torch.profiler Chrome trace to
DIR/trace.json; --shards N splits the image's rows over N shards (several
may share a card).

Implementation lives in the dip_benchmark_tpu_torch package at the repo root.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from dip_benchmark_tpu_torch.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
