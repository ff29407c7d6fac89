#!/usr/bin/env python3
"""The kernel library's build and ``chip_smoke.py``'s [3l] phase (the tile
kernels of ``csrc/conv.cu``), timed on one GPU, for one checkout.

    python3 benchmarks/h100/conv_phase.py [--tree DIR]

Imports ``dip_benchmark_tpu_torch`` and ``chip_smoke`` from ``DIR``
(default: the checkout that holds this script), deletes that checkout's
built kernel library so that the build is timed from the sources, then
runs [3l] as ``chip_smoke.py`` runs it (the checks at the edge shapes and
of every side, then the full-size drive and timings on the benchmark
image) and prints one line of seconds. Two checkouts in one call, in turns
(A B B A), tell what a change adds to ``chip_smoke.py``'s time. Needs a
CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time

import numpy as np

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree", default=HERE,
                   help="checkout whose build and [3l] are timed")
    tree = os.path.abspath(p.parse_args().tree)
    sys.path.insert(0, tree)
    import chip_smoke
    from dip_benchmark_tpu_torch.ops.kernels import build
    from dip_benchmark_tpu_torch.utils.testimage import resolve_image
    if not os.path.samefile(os.path.dirname(chip_smoke.__file__), tree):
        raise SystemExit(f"conv_phase: imported {chip_smoke.__file__}")
    shutil.rmtree(build.BUILD_ROOT, ignore_errors=True)
    t = time.perf_counter()
    build.load()
    built = time.perf_counter() - t
    img, _ = resolve_image()
    small = np.random.default_rng(7).integers(0, 256, (37, 53, 3), np.uint8)
    t0 = time.perf_counter()
    rng = np.random.default_rng(3)
    errs = chip_smoke.compare_conv_tiles(rng)
    chip_smoke.compare_dense_sides(rng)
    for shape in getattr(chip_smoke, "TWO_PASS_SIDES_SHAPES", ()):
        chip_smoke.compare_two_pass_sides(rng, shape)
    t1 = time.perf_counter()
    counts, ops, _ = chip_smoke.drive_conv_tiles(img, small)
    entries = chip_smoke.time_conv_tiles(img, ops, counts, errs)
    t2 = time.perf_counter()
    print(f"{tree}: build {built:.1f} s; [3l] checks {t1 - t0:.1f} s, "
          f"drive and timings {t2 - t1:.1f} s, total {t2 - t0:.1f} s; "
          f"{len(entries)} timed entries")
    return 0


if __name__ == "__main__":
    sys.exit(main())
