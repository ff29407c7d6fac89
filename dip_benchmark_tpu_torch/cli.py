"""CLI: the reference's three-argument contract on the port's kernels.

The port of ``dip_benchmark_tpu/cli.py`` for the kernel path, both data
models: positional infile and outdir, rounds as a flag or a third
positional, default 10000, the device gate (exit 4 when no CUDA device is
found), the device banner, then the 14-row table (one more row each
for ``--pipeline`` and ``--fuse``), the image dumps, an optional CSV row
and an optional check against the oracle: bit-exact for uint8, within 1
level plus the don't-care mask of a threshold on a computed value for
``--dtype float32``.

    python -m dip_benchmark_tpu_torch.cli <image> <outdir> --rounds N --verify
    python -m dip_benchmark_tpu_torch.cli <image> <outdir> --rounds N --pipeline
    python -m dip_benchmark_tpu_torch.cli <image> <outdir> --rounds N \
        --dtype float32 --verify --pipeline
    python -m dip_benchmark_tpu_torch.cli <image> <outdir> --rounds N \
        --verify --fuse Convolution-5x5,Inversion,Convolution-3x3

Exit codes: 0 ok, 2 refused input (argparse errors, too small an image,
a chain ``--fuse`` cannot run, a foreign CSV), 4 no device for --backend.
"""

from __future__ import annotations

import os
import sys
from argparse import ArgumentParser, ArgumentTypeError

import numpy as np

from .harness import BenchmarkRunner
from .runtime import DeviceGateError, describe_device, gate_backend
from .session import BenchmarkSession
from .utils.image import is_image_file, load_image


def parse_image(string: str) -> tuple[np.ndarray, str]:
    if not is_image_file(string):
        raise ArgumentTypeError("Not a valid image file")
    return (load_image(string), os.path.basename(string))


def parse_dir(string: str) -> str:
    if os.path.exists(string) and not os.path.isdir(string):
        raise ArgumentTypeError("Not a valid directory")
    os.makedirs(string, exist_ok=True)
    return string


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(
        prog="benchmark.py",
        description="Image processing algorithms benchmark with hand-written "
                    "CUDA kernels (PyTorch port)")
    parser.add_argument("infile", type=parse_image,
                        help="Path to image file")
    parser.add_argument("outdir", type=parse_dir,
                        help="Path to image output directory")
    parser.add_argument("rounds_pos", type=int, nargs="?", default=None,
                        metavar="rounds",
                        help="Times to be executed (positional form, "
                             "like the SYCL/VisionGL backends)")
    parser.add_argument("--rounds", type=int, default=None,
                        help="Times to be executed, default 10000")
    parser.add_argument("--backend", choices=["cuda", "cpu"], default="cuda",
                        help="Device: the CUDA kernels (default) or their "
                             "plain PyTorch versions on the host")
    parser.add_argument("--dtype", choices=["uint8", "float32"],
                        default="uint8",
                        help="Data model: uint8 HWC (default) or float32 "
                             "planar CHW in [0,1] (the CUDA.jl backend's)")
    parser.add_argument("--csv", default=None,
                        help="Also write/update a results.csv at this path")
    parser.add_argument("--tool", default=None,
                        help="Tool name for the CSV row (default H100-cuda, "
                             "or CPU-torch with --backend cpu)")
    parser.add_argument("--verify", action="store_true",
                        help="Check every op output against the oracle "
                             "before reporting (bit-exact for uint8; within "
                             "1 level for float32)")
    parser.add_argument("--pipeline", action="store_true",
                        help="Add a 15th row: the fused "
                             "grayscale+threshold+erosion+blur pipeline "
                             "as a single kernel")
    parser.add_argument("--fuse", metavar="COL,COL,...", default=None,
                        help="Add a row running an op chain fused into one "
                             "kernel (models/chain.py): comma-separated CSV "
                             "column names, e.g. 'Grayscale,Threshold,"
                             "Erosion-3x3-Square'; Grayscale only first, "
                             "total radius at most 8")
    parser.add_argument("--mem-rounds", type=int, default=None, metavar="N",
                        help="Round count override for the host-transfer "
                             "ops (Upload/Download) only; each row prints "
                             "its own N. Default: same as --rounds")
    parser.add_argument("--warmup", type=int, default=10, metavar="N",
                        help="Untimed calls after the 'once' call and before "
                             "each op's timed loop (capped at 1 for the "
                             "host-transfer ops); 0 is the strict reference "
                             "protocol")
    parser.add_argument("--stats", action="store_true",
                        help="Print per-op latency distribution "
                             "(min/p50/p95/max) under each row")
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        device = gate_backend(args.backend)
    except DeviceGateError as e:
        print(str(e), file=sys.stderr)
        return 4  # the SYCL reference's no-GPU exit code
    print(describe_device(device))

    image, filename = args.infile
    try:
        session = BenchmarkSession(image, device, dtype=args.dtype)
    except ValueError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    rounds = (args.rounds if args.rounds is not None
              else args.rounds_pos if args.rounds_pos is not None
              else 10000)
    overrides = ({"Upload": args.mem_rounds, "Download": args.mem_rounds}
                 if args.mem_rounds is not None else None)
    table = session.operations(include_pipeline=args.pipeline)
    if args.fuse:
        try:
            table.append(session.chain_operation(
                [c.strip() for c in args.fuse.split(",") if c.strip()]))
        except ValueError as e:
            print(f"--fuse: {e}", file=sys.stderr)
            return 2
    runner = BenchmarkRunner(table, rounds=rounds, stats=args.stats,
                             warmup=args.warmup, rounds_override=overrides)
    runner.run(filename=filename, outdir=args.outdir,
               verify_against=image if args.verify else None,
               verify_ops=session.oracle_ops() if args.verify else None,
               verify_atol=session.verify_atol)
    if args.csv:
        try:
            runner.write_csv(args.csv, tool=args.tool or (
                "H100-cuda" if device.type == "cuda" else "CPU-torch"))
        except ValueError as e:
            # write_csv refuses to rewrite a foreign-schema file; the rows
            # are already on stdout.
            print(f"--csv: {e}", file=sys.stderr)
            return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
