"""CLI: the reference's three-argument contract on the port.

The port of ``dip_benchmark_tpu/cli.py``, both data models and both
paths: positional infile and outdir, rounds as a flag or a third
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
    python -m dip_benchmark_tpu_torch.cli <image> <outdir> --rounds N \
        --path library --verify --pipeline
    python -m dip_benchmark_tpu_torch.cli <image> <outdir> --rounds N \
        --pipeline --exec
    python -m dip_benchmark_tpu_torch.cli <image> <outdir> --rounds N \
        --pipeline --chained 20
    python -m dip_benchmark_tpu_torch.cli <image> <outdir> --rounds N \
        --warm --profile <trace dir>
    python -m dip_benchmark_tpu_torch.cli <image> <outdir> --rounds N \
        --shards 4 --verify --pipeline [--fuse ...] [--exec]

The JAX package's paths "pallas" and "xla" are called "kernel" and
"library" here. ``--exec`` prints each op's device time per application
last: the slope over K of CUDA graphs of K launches, with its spread and
whether the chain runs from L2 (``runtime/exec_timing.py``).
``--shards N`` runs the table with the image's rows sharded over N
shards (``parallel/session.py``); with fewer CUDA devices than shards,
several shards share a device.

Exit codes: 0 ok, 2 refused input (argparse errors, ``--exec`` or
``--fuse`` with ``--chained``, ``--chained`` below 1 or with ``--verify``
or ``--shards``, ``--shards`` below 0, ``--exec`` on shards over several
devices, too small an image or shards, a chain ``--fuse`` cannot run, a
foreign CSV), 4 no device for --backend.
"""

from __future__ import annotations

import os
import sys
from argparse import ArgumentParser, ArgumentTypeError

import numpy as np

from .harness import BenchmarkRunner
from .parallel.session import ShardedBenchmarkSession
from .runtime import DeviceGateError, aot, describe_device, gate_backend
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
    parser.add_argument("--path", choices=["kernel", "library"],
                        default="kernel",
                        help="Execution path: the hand-written CUDA kernels "
                             "(default) or PyTorch library calls")
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
                             "H100-torch with --path library; CPU-torch, "
                             "CPU-torch-library with --backend cpu)")
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
    parser.add_argument("--shards", type=int, default=0, metavar="N",
                        help="Run the op matrix with the image's rows "
                             "sharded over N shards (halo rows exchanged "
                             "between neighbours; several shards may share "
                             "a CUDA device); 0 = unsharded")
    parser.add_argument("--warm", action="store_true",
                        help="Run every op of the table once, untimed, "
                             "before timing (with --chained: capture its "
                             "CUDA graphs), so the 'once' column shows a "
                             "warm launch, unlike the reference contract")
    parser.add_argument("--chained", type=int, default=None, metavar="K",
                        help="Measurement-only mode: each round runs K "
                             "chained applications of the op (one CUDA "
                             "graph on the card) and rows report the time "
                             "per application; no --verify, --fuse or "
                             "--exec")
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
    parser.add_argument("--exec", dest="exec_table", action="store_true",
                        help="After the benchmark, print each op's device "
                             "time per application: the least-squares "
                             "slope over K of CUDA graphs of K launches "
                             "(K = 10, 40, 160), with the spread of the "
                             "slope and L2-warm or L2-cold. No --chained")
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="Trace the run with torch.profiler (CPU and "
                             "CUDA activity and the port's spans) into "
                             "DIR/trace.json, a Chrome trace")
    return parser


def default_tool(device, path: str) -> str:
    """The CSV tool name: one per device kind and path, so the rows of the
    two paths do not overwrite each other."""
    if device.type == "cuda":
        return "H100-cuda" if path == "kernel" else "H100-torch"
    return "CPU-torch" if path == "kernel" else "CPU-torch-library"


def print_exec_table(rows) -> None:
    """The reference's two cells (column, seconds per application), then
    the slope b in µs, its spread (the least and most slope fitted to one
    sample) and standard error, the fixed cost a, the K values and sample
    count, and where the chain ran; a negative or unresolved slope is
    printed as it is and marked."""
    print("| device execution time per application (slope of T(K) over K) |")
    for col, t in rows:
        b, lo, hi, se, a = (1e6 * v for v in (
            t.per_app_s, t.slope_min_s, t.slope_max_s, t.stderr_s,
            t.fixed_s))
        print(f"| {col:42s} | {t.per_app_s:10.6f}s | b {b:9.3f} us | "
              f"spread {lo:9.3f}..{hi:9.3f} | se {se:7.3f} | a {a:9.2f} us "
              f"| K {','.join(map(str, t.ks))} x{t.samples} | {t.where} |"
              + (f" {t.mark} |" if t.mark else ""))


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    # Flag checks before the device gate, in the JAX CLI's order.
    if args.exec_table and args.chained:
        print("--exec is incompatible with --chained", file=sys.stderr)
        return 2
    if args.fuse and args.chained:
        print("--fuse is incompatible with --chained", file=sys.stderr)
        return 2
    if args.chained is not None and args.chained < 1:
        print(f"--chained needs K >= 1, got {args.chained}", file=sys.stderr)
        return 2
    if args.shards < 0:
        print(f"--shards needs N >= 0, got {args.shards}", file=sys.stderr)
        return 2
    try:
        device = gate_backend(args.backend)
    except DeviceGateError as e:
        print(str(e), file=sys.stderr)
        return 4  # the SYCL reference's no-GPU exit code
    print(describe_device(device))

    image, filename = args.infile
    try:
        if args.shards:
            session = ShardedBenchmarkSession(
                image, device, n_devices=args.shards, dtype=args.dtype,
                path=args.path)
        else:
            session = BenchmarkSession(image, device, dtype=args.dtype,
                                       path=args.path)
    except ValueError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    if args.exec_table and args.shards and len(session.mesh.distinct) > 1:
        print(f"--exec with --shards needs every shard on one device (a "
              f"CUDA graph spans one); {args.shards} shards span "
              f"{len(session.mesh.distinct)}", file=sys.stderr)
        return 2
    if args.chained:
        if args.verify or args.shards:
            print("--chained is measurement-only (no --verify, no "
                  "--shards)", file=sys.stderr)
            return 2
        try:
            table = session.chained_operations(
                args.chained, include_pipeline=args.pipeline)
        except ValueError as e:
            print(f"benchmark: {e}", file=sys.stderr)
            return 2
    else:
        table = session.operations(include_pipeline=args.pipeline)
    if args.fuse:
        try:
            table.append(session.chain_operation(
                [c.strip() for c in args.fuse.split(",") if c.strip()]))
        except ValueError as e:
            print(f"--fuse: {e}", file=sys.stderr)
            return 2
    if args.warm:
        aot.warm(table)
    rounds = (args.rounds if args.rounds is not None
              else args.rounds_pos if args.rounds_pos is not None
              else 10000)
    overrides = ({"Upload": args.mem_rounds, "Download": args.mem_rounds}
                 if args.mem_rounds is not None else None)
    runner = BenchmarkRunner(table, rounds=rounds, stats=args.stats,
                             warmup=args.warmup, rounds_override=overrides)

    def execute():
        runner.run(filename=filename, outdir=args.outdir,
                   verify_against=image if args.verify else None,
                   verify_ops=session.oracle_ops() if args.verify else None,
                   verify_atol=session.verify_atol)

    if args.profile:
        profile(execute, args.profile, device)
    else:
        execute()
    if args.csv:
        try:
            runner.write_csv(args.csv, tool=args.tool or default_tool(
                device, args.path))
        except ValueError as e:
            # write_csv refuses to rewrite a foreign-schema file; the rows
            # are already on stdout.
            print(f"--csv: {e}", file=sys.stderr)
            return 2
    if args.exec_table:
        print_exec_table(session.execution_table(
            include_pipeline=args.pipeline))
    return 0


def profile(execute, outdir: str, device) -> str:
    """Run ``execute`` under torch.profiler, CPU and (on the card) CUDA
    activity with the port's spans (``runtime/tracing.py``, the ``dip.*``
    annotations), and write the Chrome trace to ``outdir/trace.json``;
    returns its path."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "trace.json")
    with torch_profile(activities=activities) as prof:
        execute()
    prof.export_chrome_trace(path)
    return path


if __name__ == "__main__":
    sys.exit(main())
