#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernel library from ``dip_benchmark_tpu_torch/ops/kernels/
csrc`` with nvcc, then, with no fallback anywhere:

1. prints the device banner and ``nvidia-smi``'s name and power limit;
2. builds the kernels and prints the build time;
3. runs each of the 13 on-device ops of the uint8 model (the 12 of the
   matrix and the fused pipeline) through its kernel and through its plain
   PyTorch version on the card, on the 3504x2336 benchmark image and on
   37x53 and 5x5 images, and requires the whole outputs to be equal
   (tolerance 0: the uint8 model is bit-exact) and the crops to equal the
   oracle; then the fused pipeline on a stack of three different 3504x2336
   images, in one launch;
   [3f] the same for the 13 ops of the float32 model: kernel equal to plain
   version on the whole buffer (tolerance 0: both round every multiply and
   add once, in the same order), and the quantized crop within 1 level of
   ``oracle_f32.uint8_verify_ops()`` outside its don't-care mask;
   [3c] the fused chains C1-C4 (``CHAINS``) and Grayscale alone through
   ``chain_u8`` and ``chain_f32``: kernel equal to plain version on the
   whole buffer (tolerance 0) at 3504x2336, 37x53 and, for a radius up to
   4, 9x9, and C1 and C2 on a stack of three 3504x2336 images in one
   launch; the crops
   against the chain's sequential oracle, and C2's uint8 crop against
   ``pipeline_u8``'s, the same function;
   [3d] the morphology library surface (``MORPHOLOGY``: dilation by the
   3x3 square, cross and 5x5 diamond, erosion by the diamond in both
   models), driven once at full size with the counts zeroed and checked
   against the oracle, then each kernel equal to its plain version at
   3504x2336 and 37x53;
   [3e] every body of the uint8 window kernels, random convolution masks
   among them (rank 1, not rank 1, negative, clamping, a sum that carries
   across 16-bit fields; each held to its route, ``ConvRank1`` or
   ``ConvDense``), equal to its plain version on the whole buffer,
   tolerance 0, at ``EDGE_IMAGES`` (rows that end at or past a word or
   tile edge, heights not a multiple of the strip) and ``EDGE_BUFFERS``
   (raw planar buffers);
   [3g] ``chain_u8`` for C1-C4 and Grayscale alone, on one image and on a
   stack of two, equal to its plain version on the whole buffer, tolerance
   0, at the smallest image each chain takes, ``CHAIN_EDGE_IMAGES`` (rows
   that end short of a tile or span several, 2341x3501) and
   ``CHAIN_EDGE_BUFFERS``, and 12 stage lists no column name makes
   (``random_chain_stages``: rank-1 masks that clamp, shifts above 8);
   [3h] every body of ``window_f32_strip`` (the float32 convolutions and
   blur), random float masks among them, the same way at ``EDGE_IMAGES``
   and ``EDGE_BUFFERS``;
   [3i] ``chain_f32`` the way [3g] holds ``chain_u8``, at the same shapes
   as float32 planars, and on 12 random float32 stage lists (masks of
   10-bit ints of either sign over 2^10, separated pairs, min and point
   stages);
   [3j] ``pipeline_u8`` at ``EDGE_IMAGES`` and at ``EDGE_BUFFERS``' heights
   and pitches (three planes), alone and on stacks of 1, 2 and 3;
4. drives the port's CLI once at full size (``--rounds 50 --verify
   --pipeline --fuse C1 --csv``) with the launch counts zeroed, and
   requires exit 0, 16 table rows, 14 image dumps, a CSV row with neither
   the pipeline nor the chain column and a launch of every uint8 kernel,
   ``chain_u8`` included;
   [4f] the same with ``--dtype float32 --fuse C2``, zeroed again, and a
   launch of every float32 kernel, ``chain_f32`` included;
5. drives the batch tool (``models.batch.main``, ``--backend cuda``) over
   a directory of eight 3504x2336 images and one of another shape, with
   the counts zeroed again, and requires every output to equal the
   oracle's fused pipeline and ``pipeline_u8`` to have run; then again
   with ``--op`` C3, every output equal to the chain's sequential oracle
   and one ``chain_u8`` launch per shape group;
6. times each kernel against its plain version and, where one PyTorch call
   computes the same function, that call, with CUDA events, in the order
   kernel, plain, library, library, plain, kernel, behind a sleep kernel
   that keeps the card busy while the host queues the launches, so each
   event pair times device work and not the host's launch overhead; the
   general ``ConvDense<3,3>`` and ``<5,5>``, which the matrix's rank-1
   masks no longer reach, on ``DENSE_MASKS``; then the serving table of
   the fused pipeline at B = 1, 2, 4, 8: device µs per image, end-to-end
   ``process_batch`` ms per image, and its two host steps (layout bake,
   crop) timed alone;
   [6f] the same timings for the float32 kernels, with TF32 off for the
   ``F.conv2d`` yardsticks; every yardstick's output is held to the plain
   version within 1e-6 (on the interior, for a windowed ``F.conv2d``);
   [6c] the same for each chain in each model on its R-halo planar, with
   the summed device times of the port's unfused kernels for the same ops
   (from phases 6 and 6f) as its yardstick (no single PyTorch call
   computes a chain), and for the morphology kernels;
7. prints ``{"kernels": [...]}`` (41 entries, each with its ``dtype``),
   the ``nvidia-smi`` line and, last, ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero, and without a CUDA device the
script exits 1 before printing any result. The images, the CSVs, the
build log and a summary go to ``build/chip_smoke/`` in the checkout.
"""

from __future__ import annotations

import contextlib
import ctypes
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
import types

import numpy as np
import torch
import torch.nn.functional as F

from dip_benchmark_tpu_torch import cli, oracle, oracle_f32, spec
from dip_benchmark_tpu_torch.models import batch, chain
from dip_benchmark_tpu_torch.models.pipeline import (fused_pipeline,
                                                     fused_pipeline_plain)
from dip_benchmark_tpu_torch.ops import (OPS, OPS_F32, PLAIN, PLAIN_F32, f32,
                                         kernels, window)
from dip_benchmark_tpu_torch.ops.kernels import build
from dip_benchmark_tpu_torch.utils.image import (from_planar_padded,
                                                 from_planar_padded_f32,
                                                 load_image, make_layout,
                                                 save_image,
                                                 stack_planar_padded,
                                                 to_planar_padded,
                                                 to_planar_padded_f32)
from dip_benchmark_tpu_torch.utils.testimage import resolve_image

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "build", "chip_smoke")
TIMED_LAUNCHES = 50      # per version, in two halves
SLEEP_CYCLES = 200_000_000  # ~0.1 s of GPU clock: covers the host's queueing
SERVING_BATCHES = (1, 2, 4, 8)
SERVING_REPEATS = 3      # end-to-end process_batch calls per batch size
CSRC = "dip_benchmark_tpu_torch/ops/kernels/csrc/"
# The card's peak rates (H100 SXM data sheet):
# HBM bytes per second; int8 tensor-core operations per second, for the
# multiply-adds of u8 data by small integer weights; operations per second
# outside the tensor cores (the FP32 rate), for the uint8 model's
# compares, minima, shifts and logic.
HBM_BYTES_S = 3.35e12
MAC_OPS_S = 1979e12
ALU_OPS_S = 67e12
# float32 instructions per second: the data sheet's 67 TFLOP/s counts an
# FMA as two; an unfused multiply, add, compare or minimum is one
# instruction of 132 SMs x 128 lanes x 1.98 GHz.
F32_OPS_S = ALU_OPS_S / 2

# CSV column -> (kernel, its source, file:line and name of the TPU kernel
# it replaces).
KERNELS = {
    "Copy": ("copy_u8", "point.cu", "ops/pallas/point.py:32", "_copy_dma"),
    "Inversion": ("point_u8<Invert>", "point.cu", "ops/pallas/point.py:56",
                  "_inversion_kernel"),
    "Grayscale": ("grayscale_u8", "point.cu", "ops/pallas/point.py:110",
                  "_grayscale_kernel"),
    "Threshold": ("point_u8<Threshold>", "point.cu", "ops/pallas/point.py:72",
                  "_threshold_kernel"),
    "Erosion-3x3-Cross": ("window_u8<MinPlus>", "window.cu",
                          "ops/pallas/window.py:313",
                          "body_plus of _make_morphology"),
    "Erosion-3x3-Square": ("window_u8<MinRect>", "window.cu",
                           "ops/pallas/window.py:297",
                           "body_rect of _make_morphology"),
    "Erosion-1x3+3x1-Square": ("window_u8<MinSep>", "window.cu",
                               "ops/pallas/window.py:363",
                               "make_erosion_separated_fused"),
    "Convolution-3x3": ("window_u8<ConvRank1<3,3>>", "window.cu",
                        "ops/pallas/window.py:491",
                        "make_convolution (body_rank1 :541)"),
    "Convolution-1x3+3x1": ("window_u8<ConvSep<3>>", "window.cu",
                            "ops/pallas/window.py:606",
                            "make_convolution_separated_fused"),
    "Convolution-5x5": ("window_u8<ConvRank1<5,5>>", "window.cu",
                        "ops/pallas/window.py:491",
                        "make_convolution (body_rank1 :541)"),
    "Convolution-1x5+5x1": ("window_u8<ConvSep<5>>", "window.cu",
                            "ops/pallas/window.py:606",
                            "make_convolution_separated_fused"),
    "Gaussian-Blur-3x3": ("window_u8<Blur3x3>", "window.cu",
                          "ops/pallas/window.py:675",
                          "make_gaussian_blur_3x3"),
    "Fused-Pipeline": ("pipeline_u8", "pipeline.cu", "models/pipeline.py:30",
                       "make_fused_pipeline_pallas"),
}

# The general dense convolution, which the matrix's Gaussian masks (rank 1)
# no longer reach: timed on masks that do not factor, with negative weights
# and clamping, as a user's sharpening filter would be. Column whose work
# (WORK) it does -> (mask, shift): a 3x3 sharpen, and the 5x5 unsharp mask
# 2 * identity - Gaussian (-1/256 [1 4 6 4 1]^T [1 4 6 4 1], centre 476).
UNSHARP_5X5 = -spec.BLUR_5X5_INT
UNSHARP_5X5[2, 2] = 476
DENSE_MASKS = {
    "Convolution-3x3": (np.array([[-1, -1, -1], [-1, 12, -1],
                                  [-1, -1, -1]], np.int32), 2),
    "Convolution-5x5": (UNSHARP_5X5, 8),
}
DENSE_TPU = ("ops/pallas/window.py:491",
             "make_convolution (body_packed :562, body_i32 :581)")
# Phase 3e: images whose rows end at or past a word or tile edge and whose
# heights are not a multiple of the strip (pitches 16, 16, 32, 128, 3520),
# and raw planar buffers, where only the whole-buffer comparison applies.
EDGE_IMAGES = ((3, 3), (3, 12), (5, 28), (64, 124), (2341, 3501))
EDGE_BUFFERS = ((3, 3, 16), (1, 70, 4112))
# Phase 3g: besides the smallest image a chain takes (side max(2, R) + 1),
# images whose rows end short of a chain_u8 tile or span several, heights
# not a multiple of its rows; and raw buffers (three planes, so that a
# Grayscale-first chain takes them too).
CHAIN_EDGE_IMAGES = ((5, 28), (64, 124), (33, 481), (2341, 3501))
CHAIN_EDGE_BUFFERS = ((3, 3, 16), (3, 70, 4112))

# The same for the float32 model, all in f32.cu.
_F32 = "ops/pallas/f32.py:"
KERNELS_F32 = {
    "Copy": ("point_f32<Copy>", "f32.cu", "ops/pallas/point.py:32",
             "_copy_dma(dtype=f32)"),
    "Inversion": ("point_f32<Invert>", "f32.cu", _F32 + "27",
                  "_inversion_kernel"),
    "Grayscale": ("grayscale_f32", "f32.cu", _F32 + "36", "_grayscale"),
    "Threshold": ("point_f32<Threshold>", "f32.cu", _F32 + "31",
                  "_threshold_kernel"),
    "Erosion-3x3-Cross": ("window_f32<MinPlus>", "f32.cu", _F32 + "92",
                          "body_plus of _make_erosion"),
    "Erosion-3x3-Square": ("window_f32<MinRect>", "f32.cu", _F32 + "81",
                           "body_rect of _make_erosion"),
    "Erosion-1x3+3x1-Square": ("window_f32<MinSep>", "f32.cu", _F32 + "121",
                               "_make_erosion_sep"),
    "Convolution-3x3": ("window_f32<ConvDense<3,3>>", "f32.cu", _F32 + "133",
                        "_make_conv"),
    "Convolution-1x3+3x1": ("window_f32<ConvSep<3>>", "f32.cu",
                            _F32 + "160", "_make_conv_sep"),
    "Convolution-5x5": ("window_f32<ConvDense<5,5>>", "f32.cu", _F32 + "133",
                        "_make_conv"),
    "Convolution-1x5+5x1": ("window_f32<ConvSep<5>>", "f32.cu",
                            _F32 + "160", "_make_conv_sep"),
    "Gaussian-Blur-3x3": ("window_f32<Blur3x3>", "f32.cu", _F32 + "181",
                          "_make_blur"),
    "Fused-Pipeline": ("pipeline_f32", "f32.cu", _F32 + "194",
                       "_make_pipeline"),
}

# The fused chains driven and timed here: C1 and C3 per channel (R = 3),
# C2 grayscale first (R = 2, the pipeline's ops), C4 at the deepest halo.
CHAINS = {
    "C1": ["Convolution-5x5", "Inversion", "Convolution-3x3"],
    "C2": ["Grayscale", "Threshold", "Erosion-3x3-Square",
           "Gaussian-Blur-3x3"],
    "C3": ["Convolution-1x5+5x1", "Erosion-3x3-Cross"],
    "C4": ["Convolution-5x5"] * 4,
}
# Checked in phase 3c beside them, not timed: the luma alone, a chain with
# no stage after it (an empty descriptor).
CHECKED_CHAINS = {**CHAINS, "G": ["Grayscale"]}
# data model -> (kernel, file:line and name of the TPU kernel it replaces).
CHAIN_KERNELS = {
    "uint8": ("chain_u8", "models/chain.py:362",
              "make_fused_chain and _make_gray_chain (:530)"),
    "float32": ("chain_f32", "models/chain.py:473", "make_fused_chain_f32"),
}
DIAMOND_5X5 = np.array([[0, 0, 1, 0, 0], [0, 1, 1, 1, 0], [1, 1, 1, 1, 1],
                        [0, 1, 1, 1, 0], [0, 0, 1, 0, 0]], bool)
# The morphology library surface: (label, data model, make_* function,
# structuring element, kernel, file:line and name of the TPU kernel it
# replaces).
_W = "ops/pallas/window.py:"
MORPHOLOGY = [
    ("Dilation-3x3-Square", "uint8", window.make_dilation,
     spec.SQUARE_MASK_3X3, "window_u8<MaxRect>", _W + "353",
     "make_dilation (body_rect :297)"),
    ("Dilation-3x3-Cross", "uint8", window.make_dilation,
     spec.CROSS_MASK_3X3, "window_u8<MaxPlus>", _W + "353",
     "make_dilation (body_plus :313)"),
    ("Dilation-5x5-Diamond", "uint8", window.make_dilation, DIAMOND_5X5,
     "window_u8<Taps<Max>>", _W + "353", "make_dilation (body_generic :326)"),
    ("Erosion-5x5-Diamond", "uint8", window.make_erosion, DIAMOND_5X5,
     "window_u8<Taps<Min>>", _W + "326", "body_generic of _make_morphology"),
    ("Erosion-5x5-Diamond", "float32", f32.make_erosion, DIAMOND_5X5,
     "window_f32<Taps<Min>>", "ops/pallas/f32.py:104",
     "body_generic of _make_erosion"),
]

# The one PyTorch call that computes an op's whole-buffer function, where
# there is one: the yardstick, timed here and used nowhere in the port.
# None elsewhere: a threshold is a compare and a select, the fixed-point
# luma and F.conv2d's convolutions do not round and clamp to u8 (nor does
# F.conv2d run on uint8), PyTorch has no uint8 min-pool, and its CUDA
# max-pool refuses uint8 ("max_pool2d_with_indices_out_cuda_frame" not
# implemented for 'Byte'), so the dilations have none either.
LIBRARY = {
    "Copy": torch.clone,
    "Inversion": torch.bitwise_not,
}


def _depthwise(fmask: np.ndarray):
    """F.conv2d with a float mask on each of the three planes: the op's
    function on the interior (no zero ring), one cuDNN call."""
    w = torch.from_numpy(np.ascontiguousarray(fmask, np.float32)).cuda()
    w = w[None, None].expand(3, 1, -1, -1).contiguous()
    return lambda planar: F.conv2d(planar[None], w, groups=3)[0]


def _separable(row_mask: np.ndarray, col_mask: np.ndarray, shift: int):
    """The 1xN then Nx1 pair as one depthwise F.conv2d with their outer
    product, the dense mask the two passes compute."""
    return _depthwise(np.outer(spec.mask_float(col_mask, shift),
                               spec.mask_float(row_mask, shift)))


def library_f32() -> dict:
    """The float32 yardsticks (built on the card). The luma is one 1x1
    F.conv2d whose three output planes each weigh (R, G, B) by the luma
    weights. None for the rest: a threshold is a compare and a cast, and
    PyTorch's min-pool is a max-pool of the negation (two calls)."""
    luma = torch.tensor(spec.GRAYSCALE_WEIGHTS_RGB, dtype=torch.float32)
    luma = luma.expand(3, 3)[..., None, None].contiguous().cuda()
    return {
        "Copy": torch.clone,
        "Inversion": lambda planar: torch.rsub(planar, 1.0),
        "Grayscale": lambda planar: F.conv2d(planar[None], luma)[0],
        "Convolution-3x3": _depthwise(spec.mask_float(spec.BLUR_3X3_INT,
                                                      spec.BLUR_3X3_SHIFT)),
        "Convolution-1x3+3x1": _separable(spec.BLUR_1X3_INT,
                                          spec.BLUR_3X1_INT,
                                          spec.BLUR_SEP3_SHIFT),
        "Convolution-5x5": _depthwise(spec.mask_float(spec.BLUR_5X5_INT,
                                                      spec.BLUR_5X5_SHIFT)),
        "Convolution-1x5+5x1": _separable(spec.BLUR_1X5_INT,
                                          spec.BLUR_5X1_INT,
                                          spec.BLUR_SEP5_SHIFT),
        "Gaussian-Blur-3x3": _depthwise(spec.mask_float(spec.BLUR_3X3_INT,
                                                        spec.BLUR_3X3_SHIFT)),
    }

# Operations per position of the (Hp, pitch) plane, all three channels
# together: (multiply-adds, other operations). They set the operation
# bound beside the byte bound.
WORK = {
    "Copy": (0, 0),
    "Inversion": (0, 3),
    "Grayscale": (3, 1),
    "Threshold": (0, 3),
    "Erosion-3x3-Cross": (0, 12),
    "Erosion-3x3-Square": (0, 24),
    "Erosion-1x3+3x1-Square": (0, 12),
    "Convolution-3x3": (27, 9),
    "Convolution-1x3+3x1": (18, 18),
    "Convolution-5x5": (75, 9),
    "Convolution-1x5+5x1": (30, 18),
    "Gaussian-Blur-3x3": (27, 6),
    # luma 3 + blur 9 multiply-adds; shift, compare, 8 ANDs, round 2
    "Fused-Pipeline": (12, 12),
}
# float32 operations (multiplies, adds, compares, minima) per position of
# the plane, all three channels together, at the FP32 instruction rate.
WORK_F32 = {
    "Copy": 0,
    "Inversion": 3,
    "Grayscale": 5,                  # 3 multiplies, 2 adds, once a position
    "Threshold": 3,
    "Erosion-3x3-Cross": 12,
    "Erosion-3x3-Square": 24,
    "Erosion-1x3+3x1-Square": 12,
    "Convolution-3x3": 3 * 17,       # 9 multiplies, 8 adds
    "Convolution-1x3+3x1": 3 * 10,   # two passes of 3 multiplies, 2 adds
    "Convolution-5x5": 3 * 49,       # 25 multiplies, 24 adds
    "Convolution-1x5+5x1": 3 * 18,
    "Gaussian-Blur-3x3": 3 * 10,
    # luma 5, compare 1, separable AND 4, blur 10, once a position
    "Fused-Pipeline": 20,
}


class Model:
    """One data model as this script drives it: the port's ops and plain
    versions, the layout bake and crop, the oracle and its tolerance, the
    kernels and their yardsticks."""

    def __init__(self, dtype, ops, plain, bake, crop, oracle_ops, atol,
                 kernel_table, library):
        self.dtype, self.ops, self.plain = dtype, ops, plain
        self.bake, self.crop = bake, crop
        self.oracle_ops, self.atol = oracle_ops, atol
        self.kernels, self.library = kernel_table, library


def uint8_model() -> Model:
    return Model("uint8", OPS, PLAIN, to_planar_padded, from_planar_padded,
                 oracle.IMAGE_OPS, 0, KERNELS, LIBRARY)


def float32_model() -> Model:
    return Model("float32", OPS_F32, PLAIN_F32, to_planar_padded_f32,
                 from_planar_padded_f32, oracle_f32.uint8_verify_ops(), 1,
                 KERNELS_F32, library_f32())


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def bound(col: str, planar: torch.Tensor) -> tuple[float, str]:
    """(least ms, what bounds it) for one call of op ``col`` on
    ``planar``."""
    work = WORK_F32[col] if planar.dtype == torch.float32 else WORK[col]
    return bound_for(work, planar)


def chain_work(cols, dtype: str):
    """A chain's work per position of the plane, all planes together, as
    ``WORK`` (uint8: multiply-adds, other operations) or ``WORK_F32``
    (float32 operations) counts it: each stage on every plane, or once on
    the luma for a Grayscale-first chain."""
    gray, stages = chain._chain_stages(cols)
    planes = 1 if gray else 3
    mac = alu = ops = 0
    for st in stages:
        taps = int(np.count_nonzero(st.mask))
        if st.kind == "conv":
            mac, alu, ops = mac + taps, alu + 2, ops + 2 * taps - 1
        elif st.kind == "min":
            alu, ops = alu + taps, ops + taps
        else:
            alu, ops = alu + 1, ops + 1
    if dtype == "float32":
        return planes * ops + (5 if gray else 0)
    return (planes * mac + (3 if gray else 0), planes * alu + (1 if gray
                                                               else 0))


def bound_for(work, planar: torch.Tensor) -> tuple[float, str]:
    """(least ms, what bounds it) for ``work`` per position (as ``WORK``
    or ``WORK_F32`` counts it) on ``planar``: each input byte read once
    and each output byte written once at the HBM rate, against the
    operations at the peak rates."""
    positions = planar.numel() // planar.shape[-3]
    if planar.dtype == torch.float32:
        operations = work * positions / F32_OPS_S
    else:
        mac, alu = work
        operations = max(2 * mac * positions / MAC_OPS_S,
                         alu * positions / ALU_OPS_S)
    times = {"bytes": 2 * planar.numel() * planar.element_size()
             / HBM_BYTES_S,
             "operations": operations}
    by = max(times, key=times.get)
    return 1e3 * times[by], by


def max_delta(got: torch.Tensor, plain: torch.Tensor) -> float:
    """Largest |kernel - plain| over the whole buffer."""
    return (got.double() - plain.double()).abs().max().item()


def oracle_delta(crop: np.ndarray, expected) -> int:
    """Largest |crop - oracle| in u8 levels outside the oracle's
    don't-care mask, as the harness's --verify reads it."""
    dontcare = None
    if isinstance(expected, tuple):
        expected, dontcare = expected
    delta = np.abs(crop.astype(np.int32) - expected.astype(np.int32))
    if dontcare is not None:
        delta = np.where(dontcare, 0, delta)
    return int(delta.max(initial=0))


def compare_with_plain(model: Model, sizes) -> dict:
    """Kernel against plain version (whole buffer, tolerance 0) and oracle
    (crop, the model's tolerance) for every op and image; returns the
    largest |kernel - plain| per op."""
    errs = {col: 0 for col in model.ops}
    for label, img in sizes:
        layout = make_layout(*img.shape[:2])
        planar = model.bake(img, layout).cuda()
        for col, fn in model.ops.items():
            got, plain = fn(planar), model.plain[col](planar)
            torch.cuda.synchronize()
            err = max_delta(got, plain)
            errs[col] = max(errs[col], err)
            check(torch.equal(got, plain),
                  f"{model.dtype} {col} on {label}: kernel differs from its "
                  f"plain version (max |delta| {err})")
            off = oracle_delta(model.crop(got, layout),
                               model.oracle_ops[col](img))
            check(off <= model.atol,
                  f"{model.dtype} {col} on {label}: kernel is {off} levels "
                  f"from the oracle (tolerance {model.atol})")
        print(f"  {model.dtype} {label}: {len(model.ops)} ops equal to their "
              f"plain versions, within {model.atol} of the oracle")
    return errs


def compare_batched(model: Model, images, label) -> float:
    """The pipeline kernel on a (B, 3, Hp, pitch) stack, one launch,
    against its plain version and the oracle of each image."""
    layout = make_layout(*images[0].shape[:2])
    stack = torch.stack([model.bake(img, layout) for img in images]).cuda()
    got = model.ops["Fused-Pipeline"](stack)
    plain = model.plain["Fused-Pipeline"](stack)
    torch.cuda.synchronize()
    err = max_delta(got, plain)
    check(torch.equal(got, plain),
          f"{model.dtype} batched pipeline on {label}: kernel differs from "
          f"its plain version (max |delta| {err})")
    crops = model.crop(got, layout)
    for i, img in enumerate(images):
        off = oracle_delta(crops[i], model.oracle_ops["Fused-Pipeline"](img))
        check(off <= model.atol,
              f"{model.dtype} batched pipeline on {label}, image {i}: "
              f"{off} levels from the oracle")
    print(f"  {model.dtype} {label}: batched pipeline equal to its plain "
          f"version, within {model.atol} of the oracle")
    return err


def chain_input(model: Model, img, cols):
    """(layout, planar on the card) baked with the chain's halo, at least
    2, as the session and the batch tool bake it."""
    layout = make_layout(*img.shape[:2], pad=max(2, *chain.check_chain(cols)))
    return layout, model.bake(img, layout).cuda()


def make_chain(model: Model, layout, cols, batch: int = 0):
    make = (chain.make_fused_chain_f32 if model.dtype == "float32"
            else chain.make_fused_chain)
    return make(layout, cols, batch=batch)


def compare_chains(model: Model, sizes, variants, label) -> dict:
    """Each chain's kernel against its plain version (whole buffer,
    tolerance 0) and its sequential oracle (crop); C1 and C2 also on the
    stack of ``variants`` in one launch. Returns the largest |kernel -
    plain| per chain."""
    errs = {name: 0.0 for name in CHECKED_CHAINS}
    for size_label, img in sizes:
        checked = []
        for name, cols in CHECKED_CHAINS.items():
            r = max(chain.check_chain(cols))
            if min(img.shape[:2]) < 10 and r > 4:
                continue
            layout, planar = chain_input(model, img, cols)
            got = make_chain(model, layout, cols)(planar)
            plain = chain.fused_chain_plain(planar, cols, model.dtype)
            torch.cuda.synchronize()
            errs[name] = max(errs[name], max_delta(got, plain))
            check(torch.equal(got, plain),
                  f"{model.dtype} chain {name} on {size_label}: kernel "
                  f"differs from its plain version")
            crop = model.crop(got, layout)
            seq = chain.chain_row_parts(cols, model.dtype)[2]
            off = oracle_delta(crop, seq(img))
            check(off <= model.atol,
                  f"{model.dtype} chain {name} on {size_label}: {off} "
                  f"levels from the sequential oracle")
            if name == "C2" and model.dtype == "uint8":
                lay = make_layout(*img.shape[:2])
                pipe = fused_pipeline(to_planar_padded(img, lay).cuda())
                check(np.array_equal(crop, from_planar_padded(pipe, lay)),
                      f"chain C2 on {size_label} differs from pipeline_u8")
            checked.append(name)
        print(f"  {model.dtype} {size_label}: chains {checked} equal to "
              f"their plain versions, within {model.atol} of the oracle")
    for name in ("C1", "C2"):
        cols = CHAINS[name]
        layout = make_layout(*variants[0].shape[:2],
                             pad=max(2, *chain.check_chain(cols)))
        stack = torch.stack([model.bake(im, layout) for im in variants])
        stack = stack.cuda()
        got = make_chain(model, layout, cols, batch=len(variants))(stack)
        plain = chain.fused_chain_plain(stack, cols, model.dtype)
        torch.cuda.synchronize()
        errs[name] = max(errs[name], max_delta(got, plain))
        check(torch.equal(got, plain),
              f"{model.dtype} batched chain {name}: kernel differs from "
              f"its plain version")
        seq = chain.chain_row_parts(cols, model.dtype)[2]
        for i, crop in enumerate(model.crop(got, layout)):
            off = oracle_delta(crop, seq(variants[i]))
            check(off <= model.atol, f"{model.dtype} batched chain {name}, "
                                     f"image {i}: {off} levels off")
        print(f"  {model.dtype} B={len(variants)} {label}: chain {name} "
              f"equal to its plain version, within {model.atol} of the "
              f"oracle, one launch")
    return errs


def morphology_input(model: Model, img):
    layout = make_layout(*img.shape[:2])
    return layout, model.bake(img, layout).cuda()


def morphology_oracle(label: str, dtype: str, img, mask):
    if dtype == "float32":
        x = oracle_f32.erosion(oracle_f32.from_uint8_hwc(img), mask)
        return oracle_f32.to_uint8_hwc(x)
    fn = oracle.dilation if label.startswith("Dilation") else oracle.erosion
    return fn(img, mask)


def drive_morphology(models: dict, img) -> dict:
    """The morphology library surface at full size, as a caller drives
    it: each make_* function's op once, with the counts zeroed; each crop
    against the oracle. ``models`` maps each dtype to its ``Model``.
    Returns that run's launch counts."""
    inputs = {d: morphology_input(m, img) for d, m in models.items()}
    kernels.reset_launches()
    outs = []
    for label, dtype, make, mask, *_ in MORPHOLOGY:
        layout, planar = inputs[dtype]
        outs.append(make(layout, window.mask_to_taps(mask))(planar))
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    for (label, dtype, _, mask, name, *_), out in zip(MORPHOLOGY, outs):
        layout, _ = inputs[dtype]
        off = oracle_delta(models[dtype].crop(out, layout),
                           morphology_oracle(label, dtype, img, mask))
        check(off == 0, f"{dtype} {label}: {off} levels from the oracle")
        check(counts.get(name, 0) >= 1, f"{name} was not launched")
    print(f"  library surface at full size: every crop equal to the oracle; "
          f"launches {counts}")
    return counts


def compare_morphology(models: dict, sizes) -> list[float]:
    """Each morphology kernel against its plain version, whole buffer,
    tolerance 0; the largest |kernel - plain| of each."""
    errs = [0.0] * len(MORPHOLOGY)
    for size_label, img in sizes:
        for i, (label, dtype, make, mask, *_) in enumerate(MORPHOLOGY):
            layout, planar = morphology_input(models[dtype], img)
            taps = window.mask_to_taps(mask)
            got = make(layout, taps)(planar)
            reduce = (torch.maximum if label.startswith("Dilation")
                      else torch.minimum)
            plain = window.morphology_plain(planar, taps, reduce)
            torch.cuda.synchronize()
            errs[i] = max(errs[i], max_delta(got, plain))
            check(torch.equal(got, plain), f"{dtype} {label} on "
                  f"{size_label}: kernel differs from its plain version")
        print(f"  {size_label}: {len(MORPHOLOGY)} morphology kernels equal "
              f"to their plain versions")
    return errs


def random_masks(rng) -> list:
    """(mask, shift) for the convolutions at each size: rank 1 (ConvRank1),
    nonnegative but not rank 1, with negative weights, and one whose sum
    makes the clamp fire (ConvDense), each held to its route."""
    masks = []
    for n in (3, 5):
        u, v = rng.integers(1, 4, n), rng.integers(0, 4, n)
        v[n // 2] += 1
        carry = np.zeros(n, np.int32)  # sum 257: the rounding add carries
        carry[n // 2] = 1
        masks += [(np.outer(u, v).astype(np.int32), int(rng.integers(1, 9)),
                   "ConvRank1"),
                  (np.outer(u, v).astype(np.int32), 1, "ConvRank1"),
                  (np.outer(carry, [50] * (n // 2) + [257 - 100 * (n // 2)]
                            + [50] * (n // 2)).astype(np.int32)
                   if n == 5 else np.outer(carry, [100, 57, 100]).astype(
                       np.int32), 8, "ConvRank1"),
                  (rng.integers(0, 9, (n, n)).astype(np.int32), 5,
                   "ConvDense"),
                  (rng.integers(-9, 10, (n, n)).astype(np.int32), 3,
                   "ConvDense"),
                  (rng.integers(0, 30, (n, n)).astype(np.int32), 2,
                   "ConvDense")]
    return masks


def edge_bodies(rng) -> list:
    """(label, kernel name, op on a planar tensor, its plain version) for
    every body of the uint8 window kernels."""
    out = []
    for col in ("Erosion-3x3-Cross", "Erosion-3x3-Square",
                "Erosion-1x3+3x1-Square", "Convolution-3x3",
                "Convolution-1x3+3x1", "Convolution-5x5",
                "Convolution-1x5+5x1", "Gaussian-Blur-3x3"):
        out.append((col, KERNELS[col][0], OPS[col], PLAIN[col]))
    for label, _, make, mask, name, *_ in MORPHOLOGY:
        if name.startswith("window_u8"):
            taps = window.mask_to_taps(mask)
            reduce = "max" if label.startswith("Dilation") else "min"
            _, entry, extra = window.morphology_launch(taps, reduce)
            out.append((label, name, lambda p, n=name, e=entry, x=extra:
                        window._launch_window(n, e, p, *x),
                        lambda p, t=taps, r=reduce: window.morphology_plain(
                            p, t, torch.minimum if r == "min"
                            else torch.maximum)))
    for mask, shift, body in random_masks(rng) + [
            (m, s, "ConvDense") for m, s in DENSE_MASKS.values()]:
        name = window.convolution_launch(mask, shift)[0]
        check(body in name, f"mask {mask.tolist()} routed to {name}")
        out.append((f"{mask.tolist()} >> {shift}", name,
                    lambda p, m=mask, s=shift: window.convolution(p, m, s),
                    lambda p, m=mask, s=shift: window.conv_dense_plain(
                        p, m, s)))
    for n in (3, 5):
        row = rng.integers(-4, 9, (1, n)).astype(np.int32)
        col = rng.integers(-4, 9, (n, 1)).astype(np.int32)
        out.append((f"{row.ravel().tolist()} x {col.ravel().tolist()}",
                    f"window_u8<ConvSep<{n}>>",
                    lambda p, r=row, c=col: window.convolution_separated(
                        p, r, c, 3),
                    lambda p, r=row, c=col: window.conv_sep_plain(
                        p, r, c, 3)))
    return out


def compare_window_edges(rng) -> dict:
    """Every uint8 window body against its plain version on the whole
    buffer, tolerance 0, at EDGE_IMAGES and EDGE_BUFFERS; returns the
    largest |kernel - plain| per kernel name."""
    inputs = [(f"{h}x{w}", to_planar_padded(
        rng.integers(0, 256, (h, w, 3), np.uint8), make_layout(h, w)))
        for h, w in EDGE_IMAGES]
    inputs += [(f"raw {shape}", torch.from_numpy(
        rng.integers(0, 256, shape, np.uint8))) for shape in EDGE_BUFFERS]
    bodies = edge_bodies(rng)
    errs = {}
    for label, planar in inputs:
        planar = planar.cuda()
        for what, name, fn, plain in bodies:
            got, want = fn(planar), plain(planar)
            torch.cuda.synchronize()
            err = max_delta(got, want)
            errs[name] = max(errs.get(name, 0.0), err)
            check(torch.equal(got, want), f"{name} ({what}) on {label}: "
                  f"kernel differs from its plain version (max |delta| "
                  f"{err})")
        print(f"  {label} {tuple(planar.shape)}: {len(bodies)} window_u8 "
              f"cases equal to their plain versions")
    return errs


def chain_edge_inputs(rng, cols) -> list:
    """(label, uint8 planar on the CPU) for the chain ``cols``: the smallest
    image it takes, each of CHAIN_EDGE_IMAGES that fits its halo, and
    CHAIN_EDGE_BUFFERS."""
    pad = max(2, *chain.check_chain(cols))
    shapes = [(pad + 1, pad + 1)] + [hw for hw in CHAIN_EDGE_IMAGES
                                     if min(hw) > pad]
    inputs = [(f"{h}x{w}", to_planar_padded(
        rng.integers(0, 256, (h, w, 3), np.uint8),
        make_layout(h, w, pad=pad))) for h, w in shapes]
    return inputs + [(f"raw {shape}", torch.from_numpy(
        rng.integers(0, 256, shape, np.uint8))) for shape in
        CHAIN_EDGE_BUFFERS]


def raw_chain(shape, cols, batch: int = 0, dtype: str = "uint8"):
    """The chain ``cols`` in data model ``dtype`` for any (C, Hp, pitch)
    buffer ``shape``, through a stand-in for its layout (the chain reads
    only these three fields), with the deepest halo."""
    layout = types.SimpleNamespace(pad=chain.MAX_CHAIN_RADIUS,
                                   channels=shape[0], shape=tuple(shape))
    return chain.FusedChain(layout, cols, dtype, batch)


def random_chain_stages(rng, n: int, float32: bool = False) -> list:
    """``n`` stage lists that no column name makes, radii summing to at most
    8, with 1xN stages right before Nx1 ones, min and point stages: for
    chain_u8, rank-1 masks with random nonnegative factors and shifts (sums
    that clamp, shifts above 8); for chain_f32 (``float32``), random float
    masks, ints of up to 10 bits (either sign) over 2^10, so that most
    products round."""
    shapes = ((3, 3), (5, 5), (1, 3), (3, 1), (1, 5), (5, 1))

    def conv(kh, kw):
        if float32:
            return chain.Stage("conv", rng.integers(
                -1023, 1024, (kh, kw)).astype(np.int32), 10)
        while True:
            u, v = rng.integers(0, 5, kh), rng.integers(0, 5, kw)
            u[kh // 2] += 1
            v[kw // 2] += 1
            mask, shift = np.outer(u, v).astype(np.int32), int(
                rng.integers(0, 12))
            if 255 * mask.sum() + ((1 << shift) >> 1) < 1 << 16:
                return chain.Stage("conv", mask, shift)

    out = []
    while len(out) < n:
        stages = []
        while max(sum(st.ry for st in stages),
                  sum(st.rx for st in stages)) <= 8 and len(stages) < 6:
            k = int(rng.integers(0, 6))
            if k == 0:
                stages.append(chain.Stage(("copy", "invert", "threshold")[
                    int(rng.integers(0, 3))]))
            elif k == 1:
                stages.append(chain.Stage("min", (
                    spec.CROSS_MASK_3X3 if rng.integers(0, 2)
                    else spec.SQUARE_MASK_3X3).astype(np.int32)))
            else:
                kh, kw = shapes[int(rng.integers(0, len(shapes)))]
                stages.append(conv(kh, kw))
                if kh == 1:
                    stages.append(conv(kw, 1))
        while max(sum(st.ry for st in stages),
                  sum(st.rx for st in stages)) > 8:
            stages.pop()
        if any(st.kind != "copy" for st in stages):
            out.append(stages)
    return out


def chain_stages(stages, planar: torch.Tensor) -> torch.Tensor:
    """chain_u8 (chain_f32 for a float32 ``planar``) on a stage list itself,
    one launch over every plane of ``planar`` (one image or a stack)."""
    float32 = planar.dtype == torch.float32
    words = chain._encode(stages, float32)
    host = (ctypes.c_int * len(words))(*words.tolist())
    dev = torch.from_numpy(words).to(planar.device)
    out = torch.empty_like(planar)
    hp, pitch = planar.shape[-2:]
    kernel, entry, luma = (
        ("chain_f32", "dip_chain_f32", f32.LUMA) if float32 else
        ("chain_u8", "dip_chain_u8", (*spec.GRAYSCALE_WEIGHTS_INT_RGB,
                                      spec.GRAYSCALE_SHIFT)))
    kernels.launch(kernel, entry, planar.device, planar.data_ptr(),
                   out.data_ptr(), planar.numel() // (hp * pitch), hp, pitch,
                   0, dev.data_ptr(), host, len(words), *luma)
    return out


def stages_plain(stages, planar: torch.Tensor) -> torch.Tensor:
    """The plain stages composed, then the chain's zero ring, in the data
    model of ``planar``'s dtype."""
    float32 = planar.dtype == torch.float32
    p = planar.reshape(-1, *planar.shape[-2:])
    for st in stages:
        p = chain._stage_plain(st, p, float32)
    return window.zero_ring(p.clone(), sum(st.ry for st in stages),
                            sum(st.rx for st in stages)).reshape(
                                planar.shape)


def compare_chain_edges(rng, dtype: str = "uint8") -> dict:
    """chain_u8 (chain_f32 with ``dtype`` float32) against
    fused_chain_plain on the whole buffer, tolerance 0, for C1-C4 and
    Grayscale alone, on one image and on a stack of two, at
    ``chain_edge_inputs``' shapes (as float32 planars, raw buffers of random
    floats in [0, 1), for chain_f32), and on 12 random stage lists
    (``random_chain_stages``); the largest |kernel - plain| per chain."""
    float32 = dtype == "float32"
    name_of = "chain_f32" if float32 else "chain_u8"

    def model(label, planar):
        if not float32:
            return planar
        if label.startswith("raw"):
            return torch.from_numpy(rng.random(tuple(planar.shape),
                                               dtype=np.float32))
        return planar.float() / 255

    errs = {}
    for name, cols in CHECKED_CHAINS.items():
        for label, planar in chain_edge_inputs(rng, cols):
            shape = tuple(planar.shape)
            planar = model(label, planar).cuda()
            stack = torch.stack([planar, planar.flip(-1).contiguous()])
            for p, batch in ((planar, 0), (stack, 2)):
                got = raw_chain(shape, cols, batch, dtype)(p)
                want = chain.fused_chain_plain(p, cols, dtype)
                torch.cuda.synchronize()
                err = max_delta(got, want)
                errs[name] = max(errs.get(name, 0.0), err)
                check(torch.equal(got, want), f"{name_of} {name} on {label} "
                      f"(batch {batch}): kernel differs from its plain "
                      f"version (max |delta| {err})")
        print(f"  {name} {','.join(cols)}: equal to its plain version at "
              f"every edge shape, one image and B=2")
    inputs = [("33x481", to_planar_padded(
        rng.integers(0, 256, (33, 481, 3), np.uint8),
        make_layout(33, 481, pad=8)))] + [
        (f"raw {shape}", torch.from_numpy(rng.integers(
            0, 256, shape, np.uint8))) for shape in CHAIN_EDGE_BUFFERS]
    stage_lists = random_chain_stages(rng, 12, float32)
    for label, planar in inputs:
        planar = model(label, planar).cuda()
        for stages in stage_lists:
            got, want = chain_stages(stages, planar), stages_plain(stages,
                                                                   planar)
            torch.cuda.synchronize()
            err = max_delta(got, want)
            errs["random"] = max(errs.get("random", 0.0), err)
            check(torch.equal(got, want), f"{name_of} on {label}, stages "
                  f"{[(st.kind, st.mask.tolist(), st.shift) for st in stages]}"
                  f": kernel differs from its plain version (max |delta| "
                  f"{err})")
    what = ("masks of 10-bit ints over 2^10, separated pairs" if float32
            else "rank-1 masks that clamp, shifts up to 11")
    print(f"  {len(stage_lists)} random stage lists ({what}): equal to their "
          f"plain versions")
    return errs


def pipeline_edge_inputs(rng) -> list:
    """(label, (3, Hp, pitch) uint8 planar on the CPU) for pipeline_u8:
    EDGE_IMAGES, and EDGE_BUFFERS' heights and pitches as raw three-plane
    buffers."""
    inputs = [(f"{h}x{w}", to_planar_padded(
        rng.integers(0, 256, (h, w, 3), np.uint8), make_layout(h, w)))
        for h, w in EDGE_IMAGES]
    return inputs + [(f"raw {(3, *shape[1:])}", torch.from_numpy(
        rng.integers(0, 256, (3, *shape[1:]), np.uint8)))
        for shape in EDGE_BUFFERS]


def compare_pipeline_edges(rng) -> float:
    """pipeline_u8 against fused_pipeline_plain on the whole buffer,
    tolerance 0, at ``pipeline_edge_inputs`` alone and on stacks of 1, 2
    and 3 (the image, its mirror, noise); the largest |kernel - plain|."""
    worst = 0.0
    for label, planar in pipeline_edge_inputs(rng):
        planar = planar.cuda()
        others = [planar.flip(-1).contiguous(), torch.from_numpy(
            rng.integers(0, 256, tuple(planar.shape), np.uint8)).cuda()]
        cases = [planar] + [torch.stack([planar, *others][:b])
                            for b in (1, 2, 3)]
        for p in cases:
            got = fused_pipeline(p)
            want = fused_pipeline_plain(p)
            torch.cuda.synchronize()
            err = max_delta(got, want)
            worst = max(worst, err)
            check(torch.equal(got, want), f"pipeline_u8 on {label}, shape "
                  f"{tuple(p.shape)}: kernel differs from its plain version "
                  f"(max |delta| {err})")
        print(f"  {label} {tuple(planar.shape)}: pipeline_u8 equal to its "
              f"plain version alone and on stacks of 1, 2, 3")
    return worst


def f32_edge_bodies(rng) -> list:
    """(label, kernel name, op on a float32 planar tensor, its plain
    version) for every body of window_f32_strip: the matrix's masks and
    random ones (ints of up to 10 bits over 2^10, so that most products
    round), ``ConvSep`` with random row and column masks."""
    out = [("Blur3x3", "window_f32<Blur3x3>", f32.gaussian_blur_3x3,
            f32.blur3x3_plain)]
    for n, mask, shift in ((3, spec.BLUR_3X3_INT, spec.BLUR_3X3_SHIFT),
                           (5, spec.BLUR_5X5_INT, spec.BLUR_5X5_SHIFT)):
        for m, s in ((mask, shift),
                     (rng.integers(-1000, 1001, (n, n)).astype(np.int32),
                      10)):
            out.append((f"{m.tolist()} >> {s}",
                        f"window_f32<ConvDense<{n},{n}>>",
                        lambda p, m=m, s=s: f32.convolution(p, m, s),
                        lambda p, m=m, s=s: f32.conv_dense_plain(p, m, s)))
        row = rng.integers(-1000, 1001, (1, n)).astype(np.int32)
        col = rng.integers(-1000, 1001, (n, 1)).astype(np.int32)
        out.append((f"{row.ravel().tolist()} x {col.ravel().tolist()}",
                    f"window_f32<ConvSep<{n}>>",
                    lambda p, r=row, c=col: f32.convolution_separated(
                        p, r, c, 10),
                    lambda p, r=row, c=col: f32.conv_sep_plain(p, r, c, 10)))
    return out


def compare_f32_window_edges(rng) -> dict:
    """Every window_f32_strip body against its plain version on the whole
    buffer, tolerance 0, at EDGE_IMAGES and EDGE_BUFFERS (random floats in
    [0, 1)); the largest |kernel - plain| per kernel name."""
    inputs = [(f"{h}x{w}", to_planar_padded_f32(
        rng.integers(0, 256, (h, w, 3), np.uint8), make_layout(h, w)))
        for h, w in EDGE_IMAGES]
    inputs += [(f"raw {shape}", torch.from_numpy(
        rng.random(shape, dtype=np.float32))) for shape in EDGE_BUFFERS]
    bodies = f32_edge_bodies(rng)
    errs = {}
    for label, planar in inputs:
        planar = planar.cuda()
        for what, name, fn, plain in bodies:
            got, want = fn(planar), plain(planar)
            torch.cuda.synchronize()
            err = max_delta(got, want)
            errs[name] = max(errs.get(name, 0.0), err)
            check(torch.equal(got, want), f"{name} ({what}) on {label}: "
                  f"kernel differs from its plain version (max |delta| "
                  f"{err})")
        print(f"  {label} {tuple(planar.shape)}: {len(bodies)} "
              f"window_f32_strip cases equal to their plain versions")
    return errs


def drive_main_path(model: Model, img, label, fuse) -> dict:
    """Run the port's CLI once at full size with the pipeline row and the
    chain ``fuse`` in ``model``'s data model; return that run's launch
    counts."""
    path = os.path.join(OUT, "benchmark-image.png")
    save_image(path, img)
    suffix = "" if model.dtype == "uint8" else "-" + model.dtype
    dumps = os.path.join(OUT, "dumps" + suffix)
    shutil.rmtree(dumps, ignore_errors=True)
    csv = os.path.join(OUT, f"results{suffix}.csv")
    if os.path.exists(csv):
        os.unlink(csv)
    buf = io.StringIO()
    kernels.reset_launches()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([path, dumps, "--rounds", "50", "--verify",
                       "--pipeline", "--fuse", ",".join(fuse),
                       "--dtype", model.dtype, "--csv", csv])
    counts = dict(kernels.LAUNCHES)
    text = buf.getvalue()
    print(text, end="")
    check(rc == 0, f"cli.main exited {rc}")
    rows = [ln for ln in text.splitlines() if ln.startswith("| ")]
    check(len(rows) == 16, f"expected 16 table rows, got {len(rows)}")
    prefixes = [p for _, p, _ in spec.OPERATION_MATRIX if p] + [
        "pipeline", "chain"]
    names = [f"{p}-benchmark-image.png" for p in prefixes]
    missing = [n for n in names if not os.path.exists(os.path.join(dumps, n))]
    check(len(names) == 14 and not missing, f"missing dumps {missing}")
    with open(csv) as f:
        lines = f.read().splitlines()
    check(lines[0] == spec.CSV_HEADER and len(lines) == 2
          and lines[1].startswith("H100-cuda,")
          and len(lines[1].split(",")) == len(spec.CSV_COLUMNS) + 1,
          f"bad CSV {lines}")
    need = [k for k, *_ in model.kernels.values()]
    need.append(CHAIN_KERNELS[model.dtype][0])
    unused = [k for k in need if counts.get(k, 0) < 1]
    check(not unused, f"kernels not launched on the main path: {unused}")
    print(f"  main path ({model.dtype}, {label}): rc 0, 16 rows, 14 dumps, "
          f"--verify passed; launches {counts}")
    return counts


def write_batch_inputs(images, other) -> tuple[str, dict]:
    """A directory of ``images`` (one shape) and ``other`` (another)."""
    indir = os.path.join(OUT, "batch_in")
    shutil.rmtree(indir, ignore_errors=True)
    os.makedirs(indir)
    named = {f"img{i}.png": img for i, img in enumerate(images)}
    named["other.png"] = other
    for name, img in named.items():
        save_image(os.path.join(indir, name), img)
    return indir, named


def drive_batch_tool(indir: str, named: dict, cols=None) -> dict:
    """Run the batch tool over ``indir`` with the fused pipeline, or with
    ``--op`` the chain ``cols``; return that run's launch counts."""
    outdir = os.path.join(OUT, "batch_out" if cols is None
                          else "batch_out_chain")
    shutil.rmtree(outdir, ignore_errors=True)
    op = [] if cols is None else ["--op", ",".join(cols)]
    if cols is None:
        kernel, expect = "pipeline_u8", oracle.fused_pipeline
    else:
        kernel, expect = "chain_u8", chain.chain_row_parts(cols)[2]
    kernels.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        rc = batch.main([indir, outdir, "--batch-size", "8", *op,
                         "--backend", "cuda"])
    seconds = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    check(rc == 0, f"models.batch.main exited {rc}")
    check(sorted(os.listdir(outdir)) == sorted(named),
          f"batch outputs {sorted(os.listdir(outdir))}")
    for name, img in named.items():
        check(np.array_equal(load_image(os.path.join(outdir, name)),
                             expect(img)),
              f"batch tool: {name} differs from the oracle")
    groups = len({img.shape for img in named.values()})
    check(counts.get(kernel, 0) == groups,
          f"batch tool launched {kernel} {counts.get(kernel)} times, want "
          f"one per shape group ({groups})")
    what = "pipeline" if cols is None else "--op " + ",".join(cols)
    print(f"  batch tool ({what}): rc 0, {len(named)} images in "
          f"{seconds:.2f} s (PNG decode and encode included), every output "
          f"equal to the oracle; launches {counts} | "
          f"{buf.getvalue().strip()}")
    return counts


def device_ms(fn, planar, n: int) -> list[float]:
    """Device time of each of ``n`` launches of ``fn`` from CUDA events.
    A sleep kernel queued first keeps the card busy until the host has
    queued every launch, so no event pair spans host-side work."""
    fn(planar)
    torch.cuda.synchronize()
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for start, end in marks:
        start.record()
        fn(planar)
        end.record()
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in marks]


def timed(versions, planar) -> list[float]:
    """Median ms of each version over TIMED_LAUNCHES, in two halves run
    in the order v0, v1, ..., vn, vn, ..., v1, v0."""
    half = TIMED_LAUNCHES // 2
    samples = [[] for _ in versions]
    order = list(range(len(versions)))
    for i in order + order[::-1]:
        samples[i] += device_ms(versions[i], planar, half)
    return [statistics.median(s) for s in samples]


def host_ms(fn) -> float:
    """Median host-clock ms of SERVING_REPEATS calls of ``fn``."""
    samples = []
    for _ in range(SERVING_REPEATS):
        t0 = time.perf_counter()
        fn()
        samples.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(samples)


def serving_table(images) -> list[dict]:
    """The fused pipeline at each batch size: device time per image of
    one launch on the stack, end-to-end ``process_batch`` time per image
    (host layout bake, copy in, kernel, copy out, crop), and the two host
    steps of it timed alone: the layout bake into pinned memory and the
    crop of a pinned result to (B, H, W, 3)."""
    images = np.stack(images)
    layout = make_layout(*images.shape[1:3])
    rows = []
    for b in SERVING_BATCHES:
        stack = stack_planar_padded(images[:b], layout).cuda()
        dev_ms = timed([fused_pipeline], stack)[0]
        batch.process_batch(images[:b])  # warm the pinned-memory cache
        e2e = host_ms(lambda: batch.process_batch(images[:b]))
        bake = host_ms(lambda: stack_planar_padded(images[:b], layout,
                                                   pin_memory=True))
        pinned = stack.cpu().pin_memory()
        crop = host_ms(lambda: from_planar_padded(pinned, layout))
        bound_ms, _ = bound("Fused-Pipeline", stack)
        rows.append({"batch": b, "device_us_per_image": 1e3 * dev_ms / b,
                     "bound_us_per_image": 1e3 * bound_ms / b,
                     "e2e_ms_per_image": e2e / b,
                     "bake_ms_per_image": bake / b,
                     "crop_ms_per_image": crop / b})
    return rows


def time_kernels(model: Model, img, errs: dict, counts: dict) -> list[dict]:
    """Kernel, plain and library device time of every kernel of ``model``
    on the full-size image; one ``{"kernels": [...]}`` entry each."""
    planar = model.bake(img, make_layout(*img.shape[:2])).cuda()
    entries = []
    for col, (name, src, where, tpu_name) in model.kernels.items():
        versions = [model.ops[col], model.plain[col]]
        lib_fn = model.library.get(col)
        if lib_fn is not None:
            got = lib_fn(planar)
            # A windowed F.conv2d gives the interior only: r short a side.
            r = (planar.shape[-1] - got.shape[-1]) // 2
            want = model.plain[col](planar)
            want = want[:, r:want.shape[-2] - r, r:want.shape[-1] - r]
            err = max_delta(got, want)
            check(err <= 1e-6, f"library {col} is {err} from the plain "
                               f"version (TF32 on?)")
            versions.append(lib_fn)
        ms, plain_ms, *lib = timed(versions, planar)
        library_ms = lib[0] if lib else None
        bound_ms, bound_by = bound(col, planar)
        lib_txt = "none" if library_ms is None else f"{library_ms:9.4f} ms"
        print(f"    {col:24s} {name:28s} kernel {ms:9.4f} ms | plain "
              f"{plain_ms:9.4f} ms | library {lib_txt} | bound "
              f"{bound_ms:.4f} ms ({bound_by})")
        entries.append({
            "name": name, "dtype": model.dtype, "op": col, "route": "cuda",
            "source": CSRC + src, "replaces": "dip_benchmark_tpu/" + where,
            "tpu_kernel": tpu_name, "launches": counts.get(name, 0),
            "max_abs_err": errs[col], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms})
    return entries


def time_dense(img, errs: dict, counts: dict) -> list[dict]:
    """Kernel and plain device time of the general ConvDense on
    DENSE_MASKS at full size; it runs on the main path no more."""
    planar = to_planar_padded(img, make_layout(*img.shape[:2])).cuda()
    entries = []
    for col, (mask, shift) in DENSE_MASKS.items():
        name = window.convolution_launch(mask, shift)[0]
        ms, plain_ms = timed([
            lambda p, m=mask, s=shift: window.convolution(p, m, s),
            lambda p, m=mask, s=shift: window.conv_dense_plain(p, m, s)],
            planar)
        bound_ms, bound_by = bound(col, planar)
        op = f"{col} (mask not rank 1)"
        print(f"    {op:24s} {name:28s} kernel {ms:9.4f} ms | plain "
              f"{plain_ms:9.4f} ms | library none | bound {bound_ms:.4f} ms "
              f"({bound_by})")
        entries.append({
            "name": name, "dtype": "uint8", "op": op, "route": "cuda",
            "source": CSRC + "window.cu",
            "replaces": "dip_benchmark_tpu/" + DENSE_TPU[0],
            "tpu_kernel": DENSE_TPU[1], "launches": counts.get(name, 0),
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
    return entries


def time_chains(model: Model, img, unfused_ms: dict, errs: dict,
                counts: dict) -> list[dict]:
    """Chain kernel and plain device time of every chain on its R-halo
    full-size planar, beside the summed device times of the port's unfused
    kernels for the same ops (``unfused_ms``, by column)."""
    name, where, tpu_name = CHAIN_KERNELS[model.dtype]
    entries = []
    for cname, cols in CHAINS.items():
        layout, planar = chain_input(model, img, cols)
        fn = make_chain(model, layout, cols).prepare(planar.device)
        ms, plain_ms = timed([fn, lambda p, c=cols: chain.fused_chain_plain(
            p, c, model.dtype)], planar)
        unfused = sum(unfused_ms[c] for c in cols)
        bound_ms, bound_by = bound_for(chain_work(cols, model.dtype), planar)
        print(f"    {cname} R={layout.pad} {name:10s} kernel {ms:9.4f} ms | "
              f"plain {plain_ms:9.4f} ms | unfused kernels {unfused:9.4f} ms"
              f" | bound {bound_ms:.4f} ms ({bound_by}) | {','.join(cols)}")
        entries.append({
            "name": name, "dtype": model.dtype,
            "op": f"{cname} {','.join(cols)}", "route": "cuda",
            "source": CSRC + "chain.cu",
            "replaces": "dip_benchmark_tpu/" + where,
            "tpu_kernel": tpu_name, "launches": counts.get(name, 0),
            "max_abs_err": errs[cname], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "unfused_ms": unfused})
    return entries


def time_morphology(models: dict, img, errs: list,
                    counts: dict) -> list[dict]:
    """Kernel and plain device time of each morphology kernel at full
    size; no library call (see LIBRARY)."""
    entries = []
    for (label, dtype, make, mask, name, where, tpu_name), err in zip(
            MORPHOLOGY, errs):
        layout, planar = morphology_input(models[dtype], img)
        taps = window.mask_to_taps(mask)
        reduce = (torch.maximum if label.startswith("Dilation")
                  else torch.minimum)
        ms, plain_ms = timed([make(layout, taps), lambda p: (
            window.morphology_plain(p, taps, reduce))], planar)
        n = 3 * len(taps)
        bound_ms, bound_by = bound_for(n if dtype == "float32" else (0, n),
                                       planar)
        print(f"    {label:24s} {name:28s} kernel {ms:9.4f} ms | plain "
              f"{plain_ms:9.4f} ms | library none | bound {bound_ms:.4f} ms "
              f"({bound_by})")
        entries.append({
            "name": name, "dtype": dtype, "op": label, "route": "cuda",
            "source": CSRC + ("f32.cu" if dtype == "float32"
                              else "window.cu"),
            "replaces": "dip_benchmark_tpu/" + where, "tpu_kernel": tpu_name,
            "launches": counts.get(name, 0), "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None})
    return entries


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    os.makedirs(OUT, exist_ok=True)
    props = torch.cuda.get_device_properties(0)
    smi = nvidia_smi_line()
    print(f"[1] device: {torch.cuda.get_device_name(0)} | capability "
          f"{props.major}.{props.minor} | SMs {props.multi_processor_count} "
          f"| nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    kernels.load()
    print(f"[2] built {build.library_path()} in "
          f"{time.perf_counter() - t0:.1f} s")
    with open(os.path.join(OUT, "build.log"), "w") as f:
        f.write(build.build_log)
    for ln in build.build_log.splitlines():
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
            print("   ", ln.strip())

    img, label = resolve_image()
    rng = np.random.default_rng(0)
    sizes = [(label, img),
             ("random 37x53", rng.integers(0, 256, (37, 53, 3), np.uint8)),
             ("random 5x5", rng.integers(0, 256, (5, 5, 3), np.uint8))]
    # Eight different full-size images: the benchmark image shifted
    # sideways, its mirror, and random noise.
    h, w = img.shape[:2]
    variants = [np.ascontiguousarray(np.roll(img, 257 * i, axis=1))
                for i in range(6)]
    variants += [np.ascontiguousarray(img[::-1]),
                 rng.integers(0, 256, img.shape, np.uint8)]
    u8, f32 = uint8_model(), float32_model()
    errs = {}
    for model, tag in ((u8, "3"), (f32, "3f")):
        print(f"[{tag}] {model.dtype}: kernel against plain version, "
              f"tolerance 0; crop within {model.atol} of the oracle")
        e = compare_with_plain(model, sizes)
        e["Fused-Pipeline"] = max(
            e["Fused-Pipeline"],
            compare_batched(model, variants[5:], f"B=3 {label} variants"))
        errs[model.dtype] = e
    chain_errs = {}
    for model in (u8, f32):
        print(f"[3c] {model.dtype} fused chains: kernel against plain "
              f"version, tolerance 0; crop within {model.atol} of the "
              f"sequential oracle")
        chain_errs[model.dtype] = compare_chains(
            model, sizes[:2] + [("random 9x9", rng.integers(
                0, 256, (9, 9, 3), np.uint8))], variants[5:],
            f"{label} variants")
    print("[3d] morphology library surface: driven at full size, then "
          "kernel against plain version, tolerance 0")
    models = {"uint8": u8, "float32": f32}
    morph_counts = drive_morphology(models, img)
    morph_errs = compare_morphology(models, sizes[:2])
    print("[3e] uint8 window bodies at word, tile and strip edges, random "
          "masks: kernel against plain version, tolerance 0")
    edge_errs = compare_window_edges(rng)
    print("[3g] chain_u8 at the smallest image of each chain, tile and "
          "strip edges, one image and B=2: kernel against plain version, "
          "tolerance 0")
    chain_edge_errs = compare_chain_edges(rng)
    print("[3h] window_f32_strip bodies at word and strip edges, random "
          "masks: kernel against plain version, tolerance 0")
    f32_edge_errs = compare_f32_window_edges(rng)
    print("[3i] chain_f32 at the smallest image of each chain, tile and "
          "strip edges, one image and B=2, random float32 stage lists: "
          "kernel against plain version, tolerance 0")
    chain_f32_edge_errs = compare_chain_edges(rng, "float32")
    print("[3j] pipeline_u8 at word, strip and row edges, alone and on "
          "stacks of 1, 2, 3: kernel against plain version, tolerance 0")
    errs["uint8"]["Fused-Pipeline"] = max(errs["uint8"]["Fused-Pipeline"],
                                          compare_pipeline_edges(rng))
    for dtype, edge in (("uint8", chain_edge_errs),
                        ("float32", chain_f32_edge_errs)):
        for name, err in edge.items():
            if name in chain_errs[dtype]:
                chain_errs[dtype][name] = max(chain_errs[dtype][name], err)
    for col, (name, *_) in KERNELS_F32.items():
        if name in f32_edge_errs:
            errs["float32"][col] = max(errs["float32"][col],
                                       f32_edge_errs[name])

    counts = {}
    fuse = {"uint8": CHAINS["C1"], "float32": CHAINS["C2"]}
    for model, tag in ((u8, "4"), (f32, "4f")):
        print(f"[{tag}] main path: dip_benchmark_tpu_torch.cli.main "
              f"--dtype {model.dtype} --pipeline --fuse "
              f"{','.join(fuse[model.dtype])}")
        counts[model.dtype] = drive_main_path(model, img, label,
                                              fuse[model.dtype])

    print("[5] batch tool: dip_benchmark_tpu_torch.models.batch.main")
    other = np.ascontiguousarray(img[: h // 2, : w // 3])
    indir, named = write_batch_inputs(variants, other)
    batch_counts = drive_batch_tool(indir, named)
    chain_batch_counts = drive_batch_tool(indir, named, CHAINS["C3"])

    def timing_header(tag, model):
        print(f"[{tag}] {model.dtype} device time, median of "
              f"{TIMED_LAUNCHES} launches each, CUDA events, {label} | {smi}")

    timing_header("6", u8)
    entries = time_kernels(u8, img, errs["uint8"], counts["uint8"])
    entries += time_dense(img, edge_errs, counts["uint8"])
    print(f"    serving: fused pipeline on {label} stacks | {smi}")
    serving = serving_table(variants)
    for row in serving:
        print(f"    B={row['batch']}: device {row['device_us_per_image']:8.2f}"
              f" us/image (bound {row['bound_us_per_image']:.2f}) | "
              f"process_batch end to end {row['e2e_ms_per_image']:8.2f} "
              f"ms/image (host bake {row['bake_ms_per_image']:.2f}, "
              f"crop {row['crop_ms_per_image']:.2f})")
    timing_header("6f", f32)
    # No TF32 in the F.conv2d yardsticks: full float32, like the kernels.
    torch.backends.cudnn.allow_tf32 = False
    entries += time_kernels(f32, img, errs["float32"], counts["float32"])
    print(f"[6c] fused chains and morphology, device time, median of "
          f"{TIMED_LAUNCHES} launches each, CUDA events, {label} | {smi}")
    for model in (u8, f32):
        unfused = {e["op"]: e["ms"] for e in entries
                   if e["dtype"] == model.dtype}
        entries += time_chains(model, img, unfused, chain_errs[model.dtype],
                               counts[model.dtype])
    entries += time_morphology(models, img, morph_errs, morph_counts)

    want = 26 + len(DENSE_MASKS) + 2 * len(CHAINS) + len(MORPHOLOGY)
    check(len(entries) == want, f"{len(entries)} kernel entries, want {want}")
    summary = {"kernels": entries}
    with open(os.path.join(OUT, "summary.json"), "w") as f:
        json.dump({**summary, "serving": serving, "batch_tool_launches":
                   batch_counts, "chain_batch_tool_launches":
                   chain_batch_counts, "morphology_launches": morph_counts,
                   "main_path_launches": counts,
                   "nvidia_smi": smi, "image": label}, f, indent=1)
    print(json.dumps(summary))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
