#!/usr/bin/env python3
"""What a sharded application costs on one GPU beside its kernels: the
device time of the resident halo refresh, split into its row and column
parts.

    python3 benchmarks/h100/shard_refresh.py

For each data model and N = 1, 2, 4 shards of the 3504x2336 benchmark
image on the one card (``parallel.make_mesh``; every shard on cuda:0),
the median device time of ``chip_smoke.TIMED_LAUNCHES`` calls from CUDA
events behind a sleep kernel (``chip_smoke.timed``), of:

- ``rows``: ``refresh_resident_halo`` over the mesh row (the halo rows
  from the neighbours, the mirror on the edge shards);
- ``cols``: ``refresh_resident_cols`` on every block (the halo columns
  and the pitch's slack re-mirrored);
- ``refresh``: both, as an application runs them (``kernel_ops.refresh``);
- ``kernel``: the square erosion's kernel alone on every block;
- ``op``: the whole sharded square erosion, refresh and kernels.

Prints one line per reading, the ``nvidia-smi`` name and power limit, and
last one JSON object with every number. Needs a CUDA device and nvcc;
exits 1 without a device.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", ".."))

import chip_smoke  # noqa: E402
from dip_benchmark_tpu_torch.ops import OPS, OPS_F32, kernels  # noqa: E402
from dip_benchmark_tpu_torch.parallel import (  # noqa: E402
    make_mesh, refresh_resident_cols, refresh_resident_halo)
from dip_benchmark_tpu_torch.parallel.kernel_ops import (  # noqa: E402
    build_sharded_kernel_ops, refresh)
from dip_benchmark_tpu_torch.utils.image import to_resident_planar  # noqa: E402
from dip_benchmark_tpu_torch.utils.testimage import resolve_image  # noqa: E402

SHARDS = (1, 2, 4)
OP = "Erosion-3x3-Square"


def readings(dtype: str, planar: np.ndarray, n: int) -> dict:
    """Median µs of each part of one sharded application on n shards."""
    mesh = make_mesh(n)
    h, w = planar.shape[1:]
    ops, layout = build_sharded_kernel_ops(mesh, h, w, dtype)
    blocks = tuple(b.cuda() for b in to_resident_planar(planar, layout, n))
    kernel = (OPS_F32 if dtype == "float32" else OPS)[OP]

    def rows(b):
        return refresh_resident_halo(b, layout.pad, layout.height)

    def cols(b):
        return [refresh_resident_cols(x, layout.pad, layout.width)
                for x in b]

    versions = {
        "rows": rows,
        "cols": cols,
        "refresh": lambda b: refresh(b, mesh, layout),
        "kernel": lambda b: [kernel(x) for x in b],
        "op": ops[OP],
    }
    ms = chip_smoke.timed(list(versions.values()), blocks)
    return {name: 1e3 * t for name, t in zip(versions, ms)}


def main() -> int:
    if not torch.cuda.is_available():
        print("shard_refresh: no CUDA device", file=sys.stderr)
        return 1
    kernels.load()
    img, label = resolve_image()
    smi = chip_smoke.nvidia_smi_line()
    planar = np.ascontiguousarray(np.transpose(img, (2, 0, 1)))
    out = {"image": label, "nvidia_smi": smi, "op": OP, "us": {}}
    for dtype in ("uint8", "float32"):
        x = (planar.astype(np.float32) / np.float32(255)
             if dtype == "float32" else planar)
        for n in SHARDS:
            r = readings(dtype, x, n)
            out["us"][f"{dtype}/N={n}"] = r
            print(f"{dtype} N={n}: " + " | ".join(
                f"{k} {v:8.2f} us" for k, v in r.items()) + f" | {smi}")
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
