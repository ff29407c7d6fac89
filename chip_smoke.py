#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernel library from ``dip_benchmark_tpu_torch/ops/kernels/
csrc`` with nvcc, then, with no fallback anywhere:

1. prints the device banner and ``nvidia-smi``'s name and power limit;
2. builds the kernels and prints the build time;
   [8n] builds the native C++ oracle (``dip_benchmark_tpu_torch/native``;
   a failed build fails the run: the card's nvcc needs a host C++
   compiler anyway), holds each of its 13 columns to the NumPy oracle
   with ``array_equal`` on the benchmark image, and prints both oracles'
   host times per column and in total beside ``os.cpu_count()``;
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
   3x3 square, cross and 5x5 diamond, erosion by the diamond and the 5x5
   square in both models, and by the 17x17 square (radius 8, on a pad=8
   layout) in both models, dilation by it in uint8), driven once at full
   size with the counts zeroed and checked against the oracle, then each
   kernel equal to its plain version at 3504x2336 and 37x53;
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
   blur), random float masks among them, and the float32 ``Taps`` kernel on
   the elements of ``MORPHOLOGY``, the same way at ``EDGE_IMAGES`` and
   ``EDGE_BUFFERS``;
   [3i] ``chain_f32`` the way [3g] holds ``chain_u8``, at the same shapes
   as float32 planars, and on 12 random float32 stage lists (masks of
   10-bit ints of either sign over 2^10, separated pairs, min and point
   stages);
   [3j] ``pipeline_u8`` at ``EDGE_IMAGES`` and at ``EDGE_BUFFERS``' heights
   and pitches (three planes), alone and on stacks of 1, 2 and 3;
   [3k] the ``Taps`` kernels (uint8 min and max, float32 min) on 12 seeded
   random elements of radius 1..8 (``random_element``: sparse and dense,
   empty rows, rows of several runs, off-centre) at
   ``RANDOM_ELEMENT_IMAGES``, whole buffer, tolerance 0;
4. drives the port's CLI once at full size (``--rounds 50 --verify
   --pipeline --fuse C1 --csv``) with the launch counts zeroed, and
   requires exit 0, 16 table rows, 14 image dumps, a CSV row with neither
   the pipeline nor the chain column and a launch of every uint8 kernel,
   ``chain_u8`` included (from here to phase 4s every run's ``--verify``
   shares each oracle answer for the benchmark image, ``shared_oracle``);
   [4f] the same with ``--dtype float32 --fuse C2``, zeroed again, and a
   launch of every float32 kernel, ``chain_f32`` included;
   [4l] the library path in each data model (``--path library --rounds 20
   --verify --pipeline --exec --csv``), TF32 switched on before and the
   counts zeroed: exit 0, 15 rows, 13 dumps, a CSV row under
   ``H100-torch``, no port kernel launched, TF32 off after, and 13
   ``--exec`` rows, each a slope above 0 that every sample resolves;
5. drives the batch tool (``models.batch.main``, ``--backend cuda``) over
   a directory of eight 3504x2336 images and one of another shape, with
   the counts zeroed again, and requires every output to equal the
   oracle's fused pipeline and ``pipeline_u8`` to have run; then again
   with ``--op`` C3, every output equal to the chain's sequential oracle
   and one ``chain_u8`` launch per shape group; then with ``--op
   Convolution-5x5``, which runs on the library path: every output equal
   to the oracle and no kernel launched;
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
   [4x] the CLI's ``--exec`` in each data model (``--rounds 5 --pipeline
   --fuse`` C1 or C2): 13 + 1 rows, each a slope above 0 with its spread,
   printed beside the kernel's event time from phase 6, 6f or 6c and the
   ratio of the two, and the peak memory the CUDA graphs took;
   [4c] one replay of a K = 1 CUDA graph of each kernel op of both models
   and of each main-path chain, equal to a direct call (tolerance 0);
   then ``--chained 20 --pipeline``: 13 rows, each row's time an
   application within [0.5, 2] of the event time plus 10 µs (a row not
   divided by K is 20 times as long);
   [4p] ``--profile`` (``--rounds 20 --pipeline``): the Chrome trace names
   ``window_u8_strip`` and ``pipeline_u8`` among its CUDA kernels, and
   ``benchmarks/h100/host_share.py`` splits each kernel's rounds into
   harness, wrapper, launch, allocation, synchronize and idle; then the
   seconds the phases of this paragraph took;
   [4s] row sharding on the one card (every shard on cuda:0): each
   kernel op of both models and the main-path chain on a
   ``ShardedBenchmarkSession`` of 2, 3 and 4 shards of the benchmark
   image (3 pads its rows) and of 8 shards of the 37x53 image, the counts
   zeroed before one application that must launch the op's kernel once a
   shard and nothing else, the valid values equal to the unsharded
   session's (tolerance 0); then the CLI with the counts zeroed before
   each run: ``--shards 1 --pipeline --exec`` (uint8), ``--shards 2`` and
   ``4 --verify --pipeline --fuse`` C1 or C2 in each model (16 rows, every
   kernel of the path launched a multiple of N times; ``--exec`` in
   uint8, each slope resolved, each graph held to K direct calls),
   ``--path library --shards 4 --verify --pipeline`` (no port kernel);
   the rows' µs beside the unsharded ones (phases 4, 4f, 4x); the batch
   tool with ``--shards 2 --data-shards 2`` on the pipeline and on
   ``--op`` C3 over two full-size images and one other (every output
   equal to the oracle, ``chain_u8`` once a shard of each batch); then
   the phase's seconds; every uint8 ``--verify`` from phase 4 to here must
   have used the native oracle;
   [8w] the CLI on a 128x60000 synthetic fundus (``WIDE_SHAPE``), past
   the JAX package's single-buffer width envelope in both data models,
   with ``--rounds 2 --verify --pipeline --fuse`` C1 (uint8) or C2
   (float32), and in uint8 again with ``--shards 2``: exit 0, 16 rows,
   every kernel of the path launched, each row's µs printed; then the
   oracle that phase 4's ``--verify`` used, the oracles' times and the
   total;
7. prints ``{"kernels": [...]}`` (46 entries, each with its ``dtype``),
   the ``nvidia-smi`` line and, last, ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero, and without a CUDA device the
script exits 1 before printing any result. The images, the CSVs, the
build log and a summary go to ``build/chip_smoke/`` in the checkout.
"""

from __future__ import annotations

import contextlib
import ctypes
import importlib.util
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

from dip_benchmark_tpu_torch import cli, native, oracle, oracle_f32, spec
from dip_benchmark_tpu_torch.models import batch, chain
from dip_benchmark_tpu_torch.models.pipeline import (fused_pipeline,
                                                     fused_pipeline_plain)
from dip_benchmark_tpu_torch.ops import (OPS, OPS_F32, PLAIN, PLAIN_F32, f32,
                                         kernels, window)
from dip_benchmark_tpu_torch.ops.kernels import build
from dip_benchmark_tpu_torch.parallel.session import ShardedBenchmarkSession
from dip_benchmark_tpu_torch.runtime import exec_timing
from dip_benchmark_tpu_torch.session import (PIPELINE_DESCRIPTION,
                                             BenchmarkSession)
from dip_benchmark_tpu_torch.utils.image import (from_planar_padded,
                                                 from_planar_padded_f32,
                                                 load_image, make_layout,
                                                 save_image,
                                                 stack_planar_padded,
                                                 to_planar_padded,
                                                 to_planar_padded_f32)
from dip_benchmark_tpu_torch.utils.testimage import (resolve_image,
                                                     synth_fundus)

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
# The chain of the main path's --fuse in each data model.
MAIN_CHAINS = {"uint8": CHAINS["C1"], "float32": CHAINS["C2"]}
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
SQUARE_5X5 = np.ones((5, 5), bool)
SQUARE_17X17 = np.ones((17, 17), bool)   # radius 8: a pad=8 layout
# The morphology library surface: (label, data model, make_* function,
# structuring element, kernel, file:line and name of the TPU kernel it
# replaces). Each runs on a layout whose halo is the element's radius (at
# least the default 2).
_W = "ops/pallas/window.py:"
_GENERIC_U8 = (_W + "326", "body_generic of _make_morphology")
_GENERIC_MAX = (_W + "353", "make_dilation (body_generic :326)")
_GENERIC_F32 = ("ops/pallas/f32.py:104", "body_generic of _make_erosion")
MORPHOLOGY = [
    ("Dilation-3x3-Square", "uint8", window.make_dilation,
     spec.SQUARE_MASK_3X3, "window_u8<MaxRect>", _W + "353",
     "make_dilation (body_rect :297)"),
    ("Dilation-3x3-Cross", "uint8", window.make_dilation,
     spec.CROSS_MASK_3X3, "window_u8<MaxPlus>", _W + "353",
     "make_dilation (body_plus :313)"),
    ("Dilation-5x5-Diamond", "uint8", window.make_dilation, DIAMOND_5X5,
     "window_u8<Taps<Max>>", *_GENERIC_MAX),
    ("Erosion-5x5-Diamond", "uint8", window.make_erosion, DIAMOND_5X5,
     "window_u8<Taps<Min>>", *_GENERIC_U8),
    ("Erosion-5x5-Diamond", "float32", f32.make_erosion, DIAMOND_5X5,
     "window_f32<Taps<Min>>", *_GENERIC_F32),
    ("Erosion-5x5-Square", "uint8", window.make_erosion, SQUARE_5X5,
     "window_u8<Taps<Min>>", *_GENERIC_U8),
    ("Erosion-5x5-Square", "float32", f32.make_erosion, SQUARE_5X5,
     "window_f32<Taps<Min>>", *_GENERIC_F32),
    ("Erosion-17x17-Square", "uint8", window.make_erosion, SQUARE_17X17,
     "window_u8<Taps<Min>>", *_GENERIC_U8),
    ("Dilation-17x17-Square", "uint8", window.make_dilation, SQUARE_17X17,
     "window_u8<Taps<Max>>", *_GENERIC_MAX),
    ("Erosion-17x17-Square", "float32", f32.make_erosion, SQUARE_17X17,
     "window_f32<Taps<Min>>", *_GENERIC_F32),
]
# Phase 3k: seeded random elements of radius 1..8 (sparse and dense, with
# empty rows, rows of several runs, off-centre) at these image sizes.
RANDOM_ELEMENTS = 12
RANDOM_ELEMENT_IMAGES = ((9, 9), (37, 53), (70, 150), (133, 301))

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


def element_pad(mask) -> int:
    """The halo a layout needs for ``mask``: its radius, at least 2."""
    return max(2, mask.shape[0] // 2, mask.shape[1] // 2)


def morphology_input(model: Model, img, pad: int = 2):
    layout = make_layout(*img.shape[:2], pad=pad)
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
    inputs = {(d, element_pad(mask)): None for _, d, _, mask, *_ in
              MORPHOLOGY}
    for d, pad in inputs:
        inputs[d, pad] = morphology_input(models[d], img, pad)
    kernels.reset_launches()
    outs = []
    for label, dtype, make, mask, *_ in MORPHOLOGY:
        layout, planar = inputs[dtype, element_pad(mask)]
        outs.append(make(layout, window.mask_to_taps(mask))(planar))
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    for (label, dtype, _, mask, name, *_), out in zip(MORPHOLOGY, outs):
        layout, _ = inputs[dtype, element_pad(mask)]
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
            layout, planar = morphology_input(models[dtype], img,
                                              element_pad(mask))
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


def random_element(rng, r: int) -> tuple:
    """Seeded random taps within radius ``r``: sparse or dense, some with
    an empty row, some off-centre (a band of empty columns), some rows of
    several runs."""
    mask = rng.random((2 * r + 1, 2 * r + 1)) < rng.choice([0.2, 0.5, 0.9])
    if rng.random() < 0.5:
        mask[rng.integers(0, 2 * r + 1)] = False
    if rng.random() < 0.3:
        mask[:, :rng.integers(1, r + 1)] = False
    mask[r, r] = mask[r, r] or not mask.any()
    return window.mask_to_taps(mask)


def compare_random_elements(rng) -> dict:
    """The Taps kernels (uint8 min and max, float32 min) on RANDOM_ELEMENTS
    seeded random elements, each at every size of RANDOM_ELEMENT_IMAGES on
    a layout of its radius, against morphology_plain on the whole buffer,
    tolerance 0, driven through the make_* functions; returns the largest
    |kernel - plain| per kernel name."""
    errs = {}
    for k in range(RANDOM_ELEMENTS):
        taps = random_element(rng, 1 + k % 8)
        radius = max(max(abs(dy), abs(dx)) for dy, dx in taps)
        pad = max(2, radius)
        for h, w in RANDOM_ELEMENT_IMAGES:
            layout = make_layout(h, w, pad=pad)
            img = rng.integers(0, 256, (h, w, 3), np.uint8)
            for make, bake, reduce in (
                    (window.make_erosion, to_planar_padded, torch.minimum),
                    (window.make_dilation, to_planar_padded, torch.maximum),
                    (f32.make_erosion, to_planar_padded_f32,
                     torch.minimum)):
                op = make(layout, taps)
                planar = bake(img, layout).cuda()
                got = op(planar)
                want = window.morphology_plain(planar, taps, reduce)
                torch.cuda.synchronize()
                err = max_delta(got, want)
                errs[op.kernel] = max(errs.get(op.kernel, 0.0), err)
                check(torch.equal(got, want), f"{op.kernel} on element "
                      f"{k} {sorted(taps)} at {h}x{w}: kernel differs from "
                      f"its plain version (max |delta| {err})")
        print(f"  element {k}: radius {radius}, "
              f"{len(taps)} taps, {len(RANDOM_ELEMENT_IMAGES)} sizes x 3 "
              f"kernels equal to their plain versions")
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
    round), ``ConvSep`` with random row and column masks; and the float32
    ``Taps`` kernel on the elements of ``MORPHOLOGY``."""
    out = [("Blur3x3", "window_f32<Blur3x3>", f32.gaussian_blur_3x3,
            f32.blur3x3_plain)]
    for label, _, _, mask, name, *_ in MORPHOLOGY:
        if name.startswith("window_f32<Taps"):
            taps = window.mask_to_taps(mask)
            _, entry, extra = window.morphology_launch(taps, "min",
                                                       "float32")
            out.append((label, name, lambda p, n=name, e=entry, x=extra:
                        window._launch_window(n, e, p, *x),
                        lambda p, t=taps: window.morphology_plain(
                            p, t, torch.minimum)))
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


def drive_main_path(model: Model, img, label, fuse, rounds: int = 50,
                    name: str = "benchmark-image",
                    extra=()) -> tuple[dict, dict]:
    """Run the port's CLI once on ``img`` (saved as ``name``) with
    ``--verify``, the pipeline row and the chain ``fuse`` in ``model``'s
    data model, and ``extra`` flags; return that run's launch counts and
    its rows' µs a round (``row_us``)."""
    tag = "-".join([name, model.dtype, *extra]).replace("--", "")
    dumps = fresh("dumps-" + tag)
    csv = fresh(f"results-{tag}.csv")
    path = save_benchmark_image(img, name)
    kernels.reset_launches()
    rc, text = run_cli([path, dumps, "--rounds", str(rounds),
                        "--verify", "--pipeline", "--fuse", ",".join(fuse),
                        "--dtype", model.dtype, "--csv", csv, *extra])
    counts = dict(kernels.LAUNCHES)
    check(rc == 0, f"cli.main exited {rc}")
    rows = table_rows(text)
    check(len(rows) == 16, f"expected 16 table rows, got {len(rows)}")
    prefixes = [p for _, p, _ in spec.OPERATION_MATRIX if p] + [
        "pipeline", "chain"]
    names = [f"{p}-{name}.png" for p in prefixes]
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
    return counts, row_us(text)


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
    """Run the batch tool over ``indir`` with the fused pipeline, with
    ``--op`` the chain ``cols`` (a list), or with ``--op`` the single op
    ``cols`` (a column, which runs on the library path and launches no
    kernel); return that run's launch counts."""
    single = isinstance(cols, str)
    outdir = os.path.join(OUT, "batch_out" if cols is None
                          else "batch_out_op" if single
                          else "batch_out_chain")
    shutil.rmtree(outdir, ignore_errors=True)
    op = ([] if cols is None else ["--op", cols] if single
          else ["--op", ",".join(cols)])
    if cols is None:
        kernel, expect = "pipeline_u8", oracle.fused_pipeline
    elif single:
        kernel, expect = None, oracle.IMAGE_OPS[cols]
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
    if kernel is None:
        check(not counts, f"batch tool --op {cols} launched port kernels "
                          f"{counts}; the library path launches none")
    else:
        check(counts.get(kernel, 0) == groups,
              f"batch tool launched {kernel} {counts.get(kernel)} times, "
              f"want one per shape group ({groups})")
    what = ("pipeline" if cols is None else "--op " + cols if single
            else "--op " + ",".join(cols))
    print(f"  batch tool ({what}): rc 0, {len(named)} images in "
          f"{seconds:.2f} s (PNG decode and encode included), every output "
          f"equal to the oracle; launches {counts} | "
          f"{buf.getvalue().strip()}")
    return counts


# --exec prints this header, then one row an op (cli.print_exec_table).
EXEC_HEADER = "| device execution time per application"
CHAINED_K = 20


def run_cli(args, echo: bool = True) -> tuple[int, str]:
    """``cli.main(args)``'s exit code and standard output, echoed unless
    ``echo`` is False."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    text = buf.getvalue()
    if echo:
        print(text, end="")
    return rc, text


def table_rows(text: str) -> list[str]:
    """The benchmark table's rows (not the --exec rows)."""
    return [ln for ln in text.splitlines()
            if ln.startswith("| ") and "(once)" in ln]


# The CLI's row descriptions -> CSV column (a chain row is "Fused-Chain").
DESC_COL = {**{desc: col for desc, _, col in spec.OPERATION_MATRIX},
            PIPELINE_DESCRIPTION: "Fused-Pipeline"}


def row_us(text: str) -> dict:
    """Column -> the table row's µs a round (the repeated column)."""
    out = {}
    for ln in table_rows(text):
        cells = [c.strip() for c in ln.strip().strip("|").split("|")]
        col = ("Fused-Chain" if cells[0].startswith("Fused Chain")
               else DESC_COL[cells[0]])
        out[col] = 1e6 * float(cells[2].split("s (")[0])
    return out


def exec_rows(text: str) -> list[dict]:
    """The --exec rows: column, slope b, its spread and where it ran."""
    lines = text.splitlines()
    heads = [i for i, ln in enumerate(lines) if ln.startswith(EXEC_HEADER)]
    check(len(heads) == 1, f"{len(heads)} --exec headers")
    rows = []
    for ln in lines[heads[0] + 1:]:
        if not ln.startswith("| "):
            break
        cells = [c.strip() for c in ln.strip().strip("|").split("|")]
        spread = cells[3].split()
        rows.append({"col": cells[0], "s": float(cells[1].rstrip("s")),
                     "b_us": float(cells[2].split()[1]),
                     "lo_us": float(spread[1].rstrip(".")),
                     "hi_us": float(spread[2]),
                     "se_us": float(cells[4].split()[1]),
                     "a_us": float(cells[5].split()[1]),
                     "ks": cells[6], "where": cells[7],
                     "mark": cells[8] if len(cells) > 8 else ""})
    return rows


def check_exec_rows(rows: list[dict], cols: list[str], what: str) -> None:
    """One row a column, in order, each slope finite and above 0 with a
    spread that every sample resolves above 0, and nothing marked."""
    check([r["col"] for r in rows] == cols,
          f"{what}: --exec rows {[r['col'] for r in rows]}, want {cols}")
    for r in rows:
        check(np.isfinite(r["b_us"]) and r["b_us"] > 0 and r["lo_us"] > 0
              and r["lo_us"] <= r["b_us"] <= r["hi_us"] and not r["mark"],
              f"{what}: unresolved --exec row {r}")


def save_benchmark_image(img, name: str = "benchmark-image") -> str:
    path = os.path.join(OUT, f"{name}.png")
    save_image(path, img)
    return path


def fresh(name: str) -> str:
    """A path under OUT with nothing at it."""
    path = os.path.join(OUT, name)
    if os.path.isdir(path):
        shutil.rmtree(path)
    elif os.path.exists(path):
        os.unlink(path)
    return path


DEVICE_COLS = [c for c in KERNELS]  # the 12 device ops and the pipeline


def drive_library_path(model: Model, img) -> list[dict]:
    """[4l] The CLI on the library path with --verify, the pipeline row,
    a CSV row and --exec, with TF32 switched on before it and the launch
    counts zeroed: exit 0, 15 rows, 13 dumps, the library tool's CSV row,
    no port kernel launched, TF32 off after, 13 --exec rows."""
    t0 = time.perf_counter()
    suffix = "" if model.dtype == "uint8" else "-" + model.dtype
    dumps = fresh("dumps-library" + suffix)
    csv = fresh(f"results-library{suffix}.csv")
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    kernels.reset_launches()
    rc, text = run_cli([save_benchmark_image(img), dumps, "--path",
                        "library", "--rounds", "20", "--verify",
                        "--pipeline", "--exec", "--dtype", model.dtype,
                        "--csv", csv])
    counts = dict(kernels.LAUNCHES)
    check(rc == 0, f"cli.main --path library exited {rc}")
    check(len(table_rows(text)) == 15,
          f"expected 15 table rows, got {len(table_rows(text))}")
    prefixes = [p for _, p, _ in spec.OPERATION_MATRIX if p] + ["pipeline"]
    missing = [p for p in prefixes if not os.path.exists(
        os.path.join(dumps, f"{p}-benchmark-image.png"))]
    check(len(prefixes) == 13 and not missing, f"missing dumps {missing}")
    with open(csv) as f:
        lines = f.read().splitlines()
    check(len(lines) == 2 and lines[1].startswith("H100-torch,"),
          f"bad library CSV {lines}")
    check(not counts, f"the library path launched port kernels {counts}")
    check(torch.backends.cudnn.allow_tf32 is False
          and torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 is on after a library-path run")
    rows = exec_rows(text)
    check_exec_rows(rows, DEVICE_COLS, f"library {model.dtype}")
    print(f"  library path ({model.dtype}): rc 0, 15 rows, 13 dumps, "
          f"--verify passed, CSV row H100-torch, no port kernel launched, "
          f"TF32 off; 13 --exec rows; {time.perf_counter() - t0:.1f} s")
    return rows


def drive_exec(model: Model, img, fuse, event_ms: dict) -> dict:
    """[4x] The kernel path's --exec with the pipeline and the chain
    ``fuse``: 13 + 1 rows, each a resolved slope, printed beside the
    kernel's event time (phase 6, 6f or 6c) and the ratio of the two; the
    peak memory the graphs of the largest K took."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kernels.reset_launches()
    rc, text = run_cli([save_benchmark_image(img), fresh("exec-out"),
                        "--rounds", "5", "--pipeline", "--exec", "--fuse",
                        ",".join(fuse), "--dtype", model.dtype])
    counts = dict(kernels.LAUNCHES)
    peak_mb = (torch.cuda.max_memory_allocated() - base) / 1e6
    check(rc == 0, f"cli.main --exec exited {rc}")
    rows = exec_rows(text)
    check_exec_rows(rows, DEVICE_COLS + ["Fused-Chain"],
                    f"kernel {model.dtype}")
    print(f"  {model.dtype}: --exec slope b against the kernel's event time "
          f"(median of {TIMED_LAUNCHES} single launches); peak memory "
          f"{peak_mb:.1f} MB above {base / 1e6:.1f} MB; "
          f"{time.perf_counter() - t0:.1f} s")
    for r in rows:
        e_us = 1e3 * event_ms[r["col"]]
        r["event_us"] = e_us
        print(f"    {r['col']:24s} b {r['b_us']:9.3f} us (spread "
              f"{r['lo_us']:.3f}..{r['hi_us']:.3f}, a {r['a_us']:8.2f} us, "
              f"{r['where']}) | event {e_us:9.3f} us | b/event "
              f"{r['b_us'] / e_us:.3f}")
    return {"rows": rows, "peak_mb": peak_mb, "launches": counts}


def check_graph_replays(img) -> int:
    """[4c] One replay of a K = 1 CUDA graph of each kernel op of each
    model, and of each main-path chain, equal to a direct call of the op
    (tolerance 0); returns how many were held."""
    n = 0
    for dtype, cols in (("uint8", CHAINS["C1"]), ("float32", CHAINS["C2"])):
        session = BenchmarkSession(img, torch.device("cuda"), dtype=dtype)
        session.chain_operation(cols)
        src = session._device_input()
        name, fn, planar = session._chain_exec
        cases = [(col, session._ops[col], src) for col in DEVICE_COLS]
        cases.append((name, fn, planar))
        graphs = exec_timing.GraphCache()
        for col, op, x in cases:
            want = op(x)
            got = graphs.replay(col, op, x, 1)
            check(torch.equal(got, want), f"{dtype} {col}: the K = 1 graph "
                  f"differs from a direct call")
            n += 1
        del session, graphs
    torch.cuda.empty_cache()
    return n


def drive_chained(img, event_ms: dict) -> list[dict]:
    """[4c] The CLI with --chained and the pipeline: exit 0, 13 rows, each
    row's time per application within [0.5, 2] of the kernel's event time
    plus 10 µs, which a row not divided by K (K times as long) misses."""
    t0 = time.perf_counter()
    rc, text = run_cli([save_benchmark_image(img), fresh("chained-out"),
                        "--rounds", "20", "--pipeline", "--chained",
                        str(CHAINED_K)])
    check(rc == 0, f"cli.main --chained exited {rc}")
    rows = table_rows(text)
    check(len(rows) == 13, f"expected 13 --chained rows, got {len(rows)}")
    out = []
    for col, ln in zip(DEVICE_COLS, rows):
        per_app_us = 1e6 * float(ln.split("|")[3].split("s (")[0])
        e_us = 1e3 * event_ms[col]
        check(0.5 * e_us <= per_app_us <= 2 * e_us + 10,
              f"--chained {CHAINED_K} {col}: {per_app_us} us an "
              f"application against an event time of {e_us} us")
        out.append({"col": col, "per_app_us": per_app_us, "event_us": e_us})
    print(f"  --chained {CHAINED_K}: rc 0, 13 rows, each within "
          f"[0.5, 2] x event + 10 us; {time.perf_counter() - t0:.1f} s")
    return out


def load_host_share():
    """``benchmarks/h100/host_share.py`` as a module."""
    spec_ = importlib.util.spec_from_file_location(
        "host_share", os.path.join(ROOT, "benchmarks", "h100",
                                   "host_share.py"))
    module = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(module)
    return module


def drive_profile(img) -> list[dict]:
    """[4p] The CLI with --profile on the uint8 kernel path: the Chrome
    trace names window_u8_strip and pipeline_u8 among its CUDA kernels;
    the host share of each kernel's rounds split by host_share.py."""
    t0 = time.perf_counter()
    prof = fresh("profile")
    rc, text = run_cli([save_benchmark_image(img), fresh("profile-out"),
                        "--rounds", "20", "--pipeline", "--profile", prof])
    check(rc == 0, f"cli.main --profile exited {rc}")
    path = os.path.join(prof, "trace.json")
    check(os.path.exists(path), f"no trace at {path}")
    with open(path) as f:
        trace = json.load(f)
    names = {e["name"] for e in trace["traceEvents"]
             if e.get("cat") == "kernel"}
    for want in ("window_u8_strip", "pipeline_u8"):
        check(any(want in n for n in names),
              f"the trace names no {want} kernel")
    host_share = load_host_share()
    rows = host_share.split(path)
    check(len(rows) == 13, f"host split of {len(rows)} kernels, want 13: "
          f"{[r['kernel'] for r in rows]}")
    skew = host_share.clock_skew(trace)
    print(f"  trace {os.path.getsize(path) / 1e6:.1f} MB, "
          f"{time.perf_counter() - t0:.1f} s; kernel start - its launch "
          f"call on the trace's clocks: min {skew[0]:.1f}, median "
          f"{skew[1]:.1f}, max {skew[2]:.1f} µs (below 0 is the clock "
          f"conversion's error, in the sync columns too); host share of "
          f"a round (medians, µs; host_share.py):")
    print("    kernel | round | kernel | harness | wrapper | launch | "
          "alloc | sync wait | sync own | idle")
    for r in rows:
        print(f"    {r['kernel']} | " + " | ".join(
            f"{r[p]:.1f}" for p in host_share.PARTS)
            + f" | {100 * r['idle']:.0f} %")
    return rows



# [4s] Row sharding: the CLI's --shards on the card, and the shard counts
# whose crops are held to the unsharded session in process (3 pads the
# benchmark image's 2336 rows to 2337 + 1 + 3, the row-padding rule).
SHARDS = (2, 4)
SHARD_CHECKS = (2, 3, 4)
SHARD_CHECKS_SMALL = (8,)  # the 37x53 image: 5-row shards, 3 rows padded


def sharded_valid(blocks, pad: int, h: int, w: int) -> torch.Tensor:
    """The valid ``(C, h, w)`` region of resident blocks, on the card."""
    h_loc = blocks[0].shape[-2] - 2 * pad
    return torch.cat([b[:, pad:pad + h_loc, pad:pad + w] for b in blocks],
                     dim=1)[:, :h]


def check_sharded_crops(models, images) -> int:
    """[4s] Each kernel op of both models and the main-path chain on a
    ShardedBenchmarkSession of n shards against the unsharded session:
    the counts zeroed before one application, which must launch the op's
    kernel exactly n times and nothing else; the valid region equal at
    tolerance 0 (an op's values on the card, the chain's crop). Returns
    how many were held."""
    dev = torch.device("cuda")
    held = 0
    for label, img, ns in images:
        h, w = img.shape[:2]
        for model in models:
            whole = BenchmarkSession(img, dev, dtype=model.dtype)
            p = whole.layout.pad
            want = {col: whole._ops[col](whole.planar_dev)[:, p:p + h,
                                                            p:p + w]
                    for col in DEVICE_COLS}
            cols = MAIN_CHAINS[model.dtype]
            chain_row = whole.chain_operation(cols)
            chain_row.run()
            want_chain = chain_row.fetch()
            for n in ns:
                sharded = ShardedBenchmarkSession(img, dev, n_devices=n,
                                                  dtype=model.dtype)
                for col in DEVICE_COLS:
                    kernels.reset_launches()
                    out = sharded._ops[col](sharded.blocks)
                    torch.cuda.synchronize()
                    kernel = model.kernels[col][0]
                    check(kernels.LAUNCHES == {kernel: n},
                          f"{model.dtype} {col} on {n} shards launched "
                          f"{kernels.LAUNCHES}, want {{{kernel!r}: {n}}}")
                    check(torch.equal(sharded_valid(out, p, h, w), want[col]),
                          f"{model.dtype} {col} on {n} shards of {label} "
                          f"differs from the unsharded session")
                row = sharded.chain_operation(cols)
                kernels.reset_launches()
                row.run()
                kernel = CHAIN_KERNELS[model.dtype][0]
                check(kernels.LAUNCHES == {kernel: n},
                      f"{model.dtype} chain on {n} shards launched "
                      f"{kernels.LAUNCHES}")
                check(np.array_equal(row.fetch(), want_chain),
                      f"{model.dtype} chain on {n} shards of {label} "
                      f"differs from the unsharded session")
                held += len(DEVICE_COLS) + 1
                del sharded, row
            del whole, want
            torch.cuda.empty_cache()
        print(f"  {label}: n = {', '.join(map(str, ns))}, both models: "
              f"every op and the chain one launch a shard, equal to the "
              f"unsharded session (tolerance 0)")
    return held


def drive_sharded_cli(model: Model, img, n: int, extra) -> dict:
    """[4s] The CLI with ``--shards n`` (and ``extra``), the counts zeroed
    before: exit 0, every kernel it ran launched a multiple of n times;
    the rows' µs, the --exec rows and the launches."""
    t0 = time.perf_counter()
    kernels.reset_launches()
    rc, text = run_cli([save_benchmark_image(img),
                        fresh(f"shards{n}-{model.dtype}"), "--shards", str(n),
                        "--rounds", "20", "--mem-rounds", "5", "--dtype",
                        model.dtype, *extra], echo=False)
    counts = dict(kernels.LAUNCHES)
    check(rc == 0, f"cli.main --shards {n} {extra} exited {rc}")
    check(all(c % n == 0 for c in counts.values()),
          f"--shards {n}: launch counts {counts} not a multiple of {n}")
    rows = row_us(text)
    run = {"n": n, "dtype": model.dtype, "args": list(extra), "rows": rows,
           "launches": counts,
           "exec": exec_rows(text) if "--exec" in extra else []}
    print(f"  --shards {n} {model.dtype} {' '.join(extra)}: rc 0, "
          f"{len(rows)} rows; launches {counts}; "
          f"{time.perf_counter() - t0:.1f} s")
    run["seconds"] = time.perf_counter() - t0
    return run


def sharded_cli_runs(models, img) -> tuple[list, dict]:
    """[4s] The CLI at --shards 1 (uint8, --exec), 2 and 4 (--verify
    --pipeline --fuse, every kernel of the path launched; --exec in
    uint8), and --path library --shards 4 --verify (no port kernel)."""
    runs = [drive_sharded_cli(models[0], img, 1, ["--pipeline", "--exec"])]
    for model in models:
        fuse = ",".join(MAIN_CHAINS[model.dtype])
        exec_ = ["--exec"] if model.dtype == "uint8" else []
        for n in SHARDS:
            run = drive_sharded_cli(model, img, n, [
                "--verify", "--pipeline", "--fuse", fuse, *exec_])
            check(len(run["rows"]) == 16, f"--shards {n}: "
                  f"{len(run['rows'])} rows, want 16")
            need = [k for k, *_ in model.kernels.values()]
            need.append(CHAIN_KERNELS[model.dtype][0])
            unused = [k for k in need if run["launches"].get(k, 0) < 1]
            check(not unused, f"--shards {n} {model.dtype}: kernels not "
                  f"launched {unused}")
            if exec_:
                check_exec_rows(run["exec"], DEVICE_COLS + ["Fused-Chain"],
                                f"--shards {n} --exec")
            runs.append(run)
    library = drive_sharded_cli(models[0], img, 4, [
        "--path", "library", "--verify", "--pipeline"])
    check(not library["launches"] and len(library["rows"]) == 15,
          f"--path library --shards 4: launches {library['launches']}, "
          f"{len(library['rows'])} rows")
    return runs, library


@contextlib.contextmanager
def shared_oracle(img):
    """Each oracle answer for ``img`` computed once per data model and
    column and shared by every CLI run's --verify inside the block
    (phases 4 to 4s): the oracle is a function of the image alone, and at
    full size it takes the card's host longer than the rest of a run. Any
    other image is computed as usual. Yields, per data model, the modules
    of the oracle ops that --verify was given (the chain rows' left out)."""
    real = BenchmarkSession.oracle_ops
    answers, sources = {}, {}

    def oracle_ops(self):
        ops = real(self)
        sources.setdefault(self.dtype, set()).update(
            fn.__module__ for col, fn in ops.items()
            if not col.startswith("Fused-Chain"))

        def shared(key, fn):
            def op(image):
                if not np.array_equal(image, img):
                    return fn(image)
                if key not in answers:
                    answers[key] = fn(image)
                return answers[key]
            return op
        return {col: shared((self.dtype, col), fn)
                for col, fn in ops.items()}

    BenchmarkSession.oracle_ops = oracle_ops
    try:
        yield sources
    finally:
        BenchmarkSession.oracle_ops = real


def drive_sharded(models, img, label, small, main_us, exec_runs,
                  smi) -> dict:
    """[4s] Row sharding on the card: crops held in process, then the CLI
    at --shards 1, 2, 4 (``--verify --pipeline --fuse`` at 2 and 4, each
    kernel of the path launched; ``--exec`` in uint8), ``--path library
    --shards 4 --verify``, and the batch tool on a 2x2 mesh."""
    t0 = time.perf_counter()
    held = check_sharded_crops(models, [
        (label, img, SHARD_CHECKS), ("random 37x53", small,
                                     SHARD_CHECKS_SMALL)])
    print(f"  {held} sharded applications held; "
          f"{time.perf_counter() - t0:.1f} s")
    runs, library = sharded_cli_runs(models, img)
    for model in models:
        print(f"  {model.dtype} CLI µs a round, --rounds 20 (unsharded: "
              f"phase {'4' if model.dtype == 'uint8' else '4f'}, 50 rounds)"
              + (" | --exec b µs (unsharded: phase 4x)"
                 if model.dtype == "uint8" else "") + f" | {smi}")
        mine = [r for r in runs if r["dtype"] == model.dtype]
        ex = {r["col"]: r["b_us"] for r in exec_runs[model.dtype]["rows"]}
        for col in ["Upload", "Download"] + DEVICE_COLS + ["Fused-Chain"]:
            line = (f"    {col:24s} | {main_us[model.dtype][col]:9.1f} | "
                    + " | ".join(f"N={r['n']} {r['rows'][col]:9.1f}"
                                 if col in r["rows"] else f"N={r['n']} —"
                                 for r in mine))
            if model.dtype == "uint8" and col in ex:
                b = {r["n"]: e["b_us"] for r in mine for e in r["exec"]
                     if e["col"] == col}
                line += f" || {ex[col]:8.2f} | " + " | ".join(
                    f"N={k} {v:8.2f}" for k, v in sorted(b.items()))
            print(line)
    print(f"  library path, --shards 4 --verify: rc 0, 15 rows, no port "
          f"kernel launched; µs " + ", ".join(
              f"{c} {v:.1f}" for c, v in library["rows"].items()))
    _, named = write_batch_inputs(
        [img, np.ascontiguousarray(img[::-1])],
        np.ascontiguousarray(img[:301, :517]))
    batches = [drive_sharded_batch(named), drive_sharded_batch(
        named, CHAINS["C3"])]
    seconds = time.perf_counter() - t0
    print(f"  [4s] took {seconds:.1f} s")
    return {"held": held, "cli": runs, "library": library,
            "batch": batches, "seconds": seconds}


def drive_sharded_batch(named: dict, cols=None) -> dict:
    """[4s] The batch tool with ``--shards 2 --data-shards 2`` on the
    pipeline (the chain ``PIPELINE_COLS``) or the chain ``cols``: every
    output equal to the oracle, ``chain_u8`` launched once a shard of each
    shape group's one batch."""
    indir = os.path.join(OUT, "batch_in")
    outdir = fresh("batch_out_sharded")
    op = [] if cols is None else ["--op", ",".join(cols)]
    expect = (oracle.fused_pipeline if cols is None
              else chain.chain_row_parts(cols)[2])
    kernels.reset_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = batch.main([indir, outdir, "--batch-size", "8", "--shards", "2",
                         "--data-shards", "2", *op, "--backend", "cuda"])
    counts = dict(kernels.LAUNCHES)
    check(rc == 0, f"models.batch.main --shards 2 --data-shards 2 exited {rc}")
    for name, img in named.items():
        check(np.array_equal(load_image(os.path.join(outdir, name)),
                             expect(img)),
              f"sharded batch tool: {name} differs from the oracle")
    groups = len({img.shape for img in named.values()})
    check(counts == {"chain_u8": 4 * groups},
          f"sharded batch tool launched {counts}, want chain_u8 "
          f"{4 * groups} (4 shards x {groups} batches)")
    what = "pipeline" if cols is None else "--op " + ",".join(cols)
    print(f"  batch tool --shards 2 --data-shards 2 ({what}): rc 0, "
          f"{len(named)} images equal to the oracle; launches {counts}")
    return {"op": what, "launches": counts}


# [8w] An image past the JAX package's single-buffer width envelope: its
# uint8 kernels need column strips past 52,732 columns, its float32 ones
# past 33,660 (``utils/image.fit_band`` there). The port's kernels put the
# columns on the grid, so one buffer should serve any width.
WIDE_SHAPE = (128, 60_000)


def check_native_oracle(img, label) -> dict:
    """[8n] Build the native C++ oracle (a failure is a fault here: the
    card's nvcc needs a host C++ compiler), hold each of its 13 columns to
    the NumPy oracle bit for bit on ``img``, and time both on the host."""
    t0 = time.perf_counter()
    built = native.available()
    build_s = time.perf_counter() - t0
    check(built, f"the native oracle did not build: {native.build_error()}")
    print(f"  built {native.library_path()} in {build_s:.1f} s; host "
          f"os.cpu_count() {os.cpu_count()}; {label}")
    ops = native.image_ops()
    rows = []
    for col, fn in oracle.IMAGE_OPS.items():
        t0 = time.perf_counter()
        want = fn(img)
        t1 = time.perf_counter()
        got = ops[col](img)
        t2 = time.perf_counter()
        check(np.array_equal(got, want),
              f"[8n] native {col} differs from the NumPy oracle")
        rows.append({"col": col, "numpy_ms": 1e3 * (t1 - t0),
                     "native_ms": 1e3 * (t2 - t1)})
    print(f"    {'column':24s} | NumPy ms | native ms (array_equal on "
          f"the whole image)")
    for r in rows:
        print(f"    {r['col']:24s} | {r['numpy_ms']:8.1f} | "
              f"{r['native_ms']:8.1f}")
    total = {k: sum(r[k] for r in rows) for k in ("numpy_ms", "native_ms")}
    print(f"    {'total':24s} | {total['numpy_ms']:8.1f} | "
          f"{total['native_ms']:8.1f}")
    return {"rows": rows, **total, "build_s": build_s,
            "cpu_count": os.cpu_count()}


def drive_wide(models, smi) -> dict:
    """[8w] The CLI on a ``WIDE_SHAPE`` synthetic fundus, past both
    envelope limits, on the kernel path: ``--verify --pipeline --rounds
    2`` with the main-path chain, once per data model and once more in
    uint8 with ``--shards 2``; exit 0, 16 rows and every kernel of the
    path launched in each run (``drive_main_path``)."""
    t0 = time.perf_counter()
    img = synth_fundus(*WIDE_SHAPE)
    label = f"synth_fundus({WIDE_SHAPE[0]}x{WIDE_SHAPE[1]})"
    layout = make_layout(*WIDE_SHAPE)
    print(f"  {label}: {img.nbytes / 1e6:.1f} MB uint8, "
          f"{4 * img.nbytes / 1e6:.1f} MB float32; one planar buffer "
          f"{layout.shape} a data model | {smi}")
    runs = []
    with shared_oracle(img) as sources:
        for model, extra in ((models[0], ()), (models[1], ()),
                             (models[0], ("--shards", "2"))):
            t1 = time.perf_counter()
            counts, rows = drive_main_path(
                model, img, label, MAIN_CHAINS[model.dtype], rounds=2,
                name="wide", extra=extra)
            if extra:
                check(all(c % 2 == 0 for c in counts.values()),
                      f"[8w] --shards 2: launch counts {counts} not even")
            runs.append({"dtype": model.dtype, "args": list(extra),
                         "rows": rows, "launches": counts,
                         "seconds": time.perf_counter() - t1})
    check(sources.get("uint8") == {native.__name__},
          f"[8w] uint8 --verify used {sources.get('uint8')}, want the "
          f"native oracle")
    print(f"    {'µs a round, --rounds 2':24s} | " + " | ".join(
        f"{r['dtype']} {' '.join(r['args'])}".strip() for r in runs))
    for col in ["Upload", "Download"] + DEVICE_COLS + ["Fused-Chain"]:
        print(f"    {col:24s} | " + " | ".join(
            f"{r['rows'][col]:10.1f}" for r in runs))
    seconds = time.perf_counter() - t0
    print(f"  [8w] --verify passed in all {len(runs)} runs (oracles: "
          + "; ".join(f"{k} {', '.join(sorted(v))}"
                      for k, v in sorted(sources.items()))
          + f"); took {seconds:.1f} s")
    return {"image": label, "runs": runs, "seconds": seconds}


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
        layout, planar = morphology_input(models[dtype], img,
                                          element_pad(mask))
        taps = window.mask_to_taps(mask)
        reduce = (torch.maximum if label.startswith("Dilation")
                  else torch.minimum)
        ms, plain_ms = timed([make(layout, taps), lambda p: (
            window.morphology_plain(p, taps, reduce))], planar)
        # Operations a position: for Taps the min or max operations its
        # program does (TapsProgram.stats), else three a tap.
        n = (window.taps_program(taps, window.TAPS_TILE_ROWS[dtype])
             .stats()["ops"] if "Taps" in name else 3 * len(taps))
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
    t_start = time.perf_counter()
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
    print("[8n] native C++ oracle: built, then each column against the "
          "NumPy oracle (array_equal) and both timed on the host")
    native_oracle = check_native_oracle(img, label)
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
    print("[3k] Taps kernels on seeded random elements of radius 1..8, "
          "uint8 min and max, float32 min: kernel against plain version, "
          "tolerance 0")
    random_errs = compare_random_elements(rng)
    for i, (*_, name, _, _) in enumerate(MORPHOLOGY):
        for other in (edge_errs, f32_edge_errs, random_errs):
            morph_errs[i] = max(morph_errs[i], other.get(name, 0.0))
    for dtype, edge in (("uint8", chain_edge_errs),
                        ("float32", chain_f32_edge_errs)):
        for name, err in edge.items():
            if name in chain_errs[dtype]:
                chain_errs[dtype][name] = max(chain_errs[dtype][name], err)
    for col, (name, *_) in KERNELS_F32.items():
        if name in f32_edge_errs:
            errs["float32"][col] = max(errs["float32"][col],
                                       f32_edge_errs[name])

    counts, main_us = {}, {}
    fuse = MAIN_CHAINS
    oracle_memo = contextlib.ExitStack()
    verify_sources = oracle_memo.enter_context(shared_oracle(img))
    for model, tag in ((u8, "4"), (f32, "4f")):
        print(f"[{tag}] main path: dip_benchmark_tpu_torch.cli.main "
              f"--dtype {model.dtype} --pipeline --fuse "
              f"{','.join(fuse[model.dtype])}")
        counts[model.dtype], main_us[model.dtype] = drive_main_path(
            model, img, label, fuse[model.dtype])
    t_new = time.perf_counter()  # the phases added with --path and --exec
    library_exec = {}
    for model in (u8, f32):
        print(f"[4l] library path: dip_benchmark_tpu_torch.cli.main --path "
              f"library --dtype {model.dtype} --verify --pipeline --exec "
              f"--csv | {smi}")
        library_exec[model.dtype] = drive_library_path(model, img)
    seconds_new = time.perf_counter() - t_new

    print("[5] batch tool: dip_benchmark_tpu_torch.models.batch.main")
    other = np.ascontiguousarray(img[: h // 2, : w // 3])
    indir, named = write_batch_inputs(variants, other)
    batch_counts = drive_batch_tool(indir, named)
    chain_batch_counts = drive_batch_tool(indir, named, CHAINS["C3"])
    t_new = time.perf_counter()
    op_batch_counts = drive_batch_tool(indir, named, "Convolution-5x5")
    seconds_new += time.perf_counter() - t_new

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

    t_new = time.perf_counter()
    event_ms = {}
    for model in (u8, f32):
        event_ms[model.dtype] = {e["op"]: e["ms"] for e in entries
                                 if e["dtype"] == model.dtype}
        chain_op = next(e["op"] for e in entries if e["dtype"] == model.dtype
                        and e["op"].startswith(
                            f"C{1 if model is u8 else 2} "))
        event_ms[model.dtype]["Fused-Chain"] = event_ms[model.dtype][chain_op]
    exec_runs = {}
    for model in (u8, f32):
        print(f"[4x] execution time: dip_benchmark_tpu_torch.cli.main "
              f"--dtype {model.dtype} --pipeline --exec --fuse "
              f"{','.join(fuse[model.dtype])} | {smi}")
        exec_runs[model.dtype] = drive_exec(model, img, fuse[model.dtype],
                                            event_ms[model.dtype])
    print(f"[4c] chained: K = 1 CUDA graphs against direct calls, then "
          f"dip_benchmark_tpu_torch.cli.main --pipeline --chained "
          f"{CHAINED_K} | {smi}")
    t0 = time.perf_counter()
    n = check_graph_replays(img)
    print(f"  {n} K = 1 graph replays equal to direct calls (tolerance 0); "
          f"{time.perf_counter() - t0:.1f} s")
    chained = drive_chained(img, event_ms["uint8"])
    print(f"[4p] profile: dip_benchmark_tpu_torch.cli.main --pipeline "
          f"--profile | {smi}")
    host_split = drive_profile(img)
    seconds_new += time.perf_counter() - t_new
    print(f"[4l 4x 4c 4p 5] the phases of --path, --exec, --chained, "
          f"--profile and the batch tool's library op took "
          f"{seconds_new:.1f} s")
    print(f"[4s] row sharding: ShardedBenchmarkSession against the "
          f"unsharded session, dip_benchmark_tpu_torch.cli.main --shards "
          f"1, 2, 4, models.batch.main --shards 2 --data-shards 2 | {smi}")
    sharded = drive_sharded([u8, f32], img, label, sizes[1][1], main_us,
                            exec_runs, smi)
    oracle_memo.close()
    check(verify_sources.get("uint8") == {native.__name__},
          f"uint8 --verify used {verify_sources.get('uint8')}, want the "
          f"native oracle")
    native_oracle["verify_sources"] = {k: sorted(v) for k, v in
                                       verify_sources.items()}
    print(f"[8w] widths past the JAX envelope: dip_benchmark_tpu_torch.cli."
          f"main on {WIDE_SHAPE[0]}x{WIDE_SHAPE[1]}")
    wide = drive_wide([u8, f32], smi)

    want = 26 + len(DENSE_MASKS) + 2 * len(CHAINS) + len(MORPHOLOGY)
    check(len(entries) == want, f"{len(entries)} kernel entries, want {want}")
    summary = {"kernels": entries}
    with open(os.path.join(OUT, "summary.json"), "w") as f:
        json.dump({**summary, "serving": serving, "batch_tool_launches":
                   batch_counts, "chain_batch_tool_launches":
                   chain_batch_counts, "op_batch_tool_launches":
                   op_batch_counts, "morphology_launches": morph_counts,
                   "main_path_launches": counts, "library_exec": library_exec,
                   "exec": exec_runs, "chained": chained,
                   "host_share": host_split, "sharded": sharded,
                   "native_oracle": native_oracle, "wide": wide,
                   "nvidia_smi": smi,
                   "image": label}, f, indent=1)
    print("[8n] --verify's oracle from phase 4 to 4s: " + "; ".join(
        f"{k} {', '.join(v)}" for k, v in sorted(
            native_oracle["verify_sources"].items()))
          + f" | oracle on {label}: NumPy {native_oracle['numpy_ms']:.1f} "
          f"ms, native {native_oracle['native_ms']:.1f} ms for 13 columns, "
          f"os.cpu_count() {native_oracle['cpu_count']}")
    print(f"[7] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(summary))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
