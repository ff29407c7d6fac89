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
   [3h] every body of ``window_f32_strip`` (the float32 3x3 erosions,
   convolutions and blur), random float masks among them, and the float32
   ``Taps`` kernel on the elements of ``MORPHOLOGY``, the same way at
   ``EDGE_IMAGES`` and ``EDGE_BUFFERS``;
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
   [3l] the tile kernels of ``csrc/conv.cu`` (every mask shape the JAX
   package builds that the strip bodies do not): every dense kh x kw with
   sides in ``CONV_SIDES`` (1, 2, 3, 5, 7, 9, 17) in both models, random
   weights of either sign (uint8: the int8 tensor-core body), and in
   uint8 the same shapes with one weight of +-200 (the IMAD body), masks of
   int8's end weights, factoring masks (the two-pass form unrounded
   between), separable N 1 to 17 in both models, an ``acc_dtype``,
   masks whose int32 sums wrap (the IMAD body), at ``EDGE_IMAGES`` on pad-8
   layouts (raw buffers of that shape where an image is smaller than 9)
   and ``EDGE_BUFFERS``, whole buffer, tolerance 0; every kh x kw of
   1..17 on each dense body (``compare_dense_sides``, so that every
   instantiation runs) on ``DENSE_SIDES_SHAPE``; every N of 1..17 on each
   two-pass kernel (``compare_two_pass_sides``: uint8 rounded between,
   unrounded N x N and N x kw, row weights of 1, 2 and more digits, so
   that each of its 102 instantiations runs; float32) on
   ``TWO_PASS_SIDES_SHAPES``; then ``CONV_TIMED``
   (7x7, 17x17, 1x17 dense, separable N 9 and 17, both models; the three
   dense uint8 shapes again with a weight of 200, and as box filters that
   factor: the two-pass form unrounded) through the builders on
   the pad-8 planar ``(3, 2352, 3520)`` of the benchmark image, driven
   once with the counts zeroed (each of the five kernels launched), every
   output equal to its plain version, the same builders' crops on 37x53
   equal to the oracle, and each timed as phase 6 times (kernel, plain,
   and for float32 one depthwise ``F.conv2d``) beside its bound;
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
   oracle's fused pipeline and one ``bake_u8``, one ``pipeline_u8`` and
   one ``crop_u8`` launch per chunk (``models.batch.chunks``) of each
   shape group's batch; then again with ``--op`` C3, every output equal
   to the chain's sequential oracle and one ``bake_u8``, one ``chain_u8``
   and one ``crop_u8`` launch per chunk; then with ``--op
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
   ``process_batch`` ms per image, the layout bake on the card
   (``bake_u8``, device ms per image, its output equal to the host's
   bake at each B) beside the host's NumPy bake, and the crop on the card
   (``crop_u8``, its output equal to the host's crop at each B) beside
   its plain version on the card and the host's crop it replaced;
   ``bake_u8``'s and ``crop_u8``'s entries at B = 8 beside their plain
   versions;
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
   ``benchmarks/h100/host_share.py`` splits each kernel's rounds, found
   by the port's spans, into harness, wrapper, launch, allocation,
   synchronize and idle, and the idle time of a round by the span the
   host was in (``idle_by_span``, its parts summing to the idle time
   within 1 %), beside the clock skew; then the seconds the phases of
   this paragraph took;
   [4s] row sharding on the one card (every shard on cuda:0): each
   kernel op of both models and the main-path chain on a
   ``ShardedBenchmarkSession`` of 2, 3 and 4 shards of the benchmark
   image (3 pads its rows) and of 8 shards of the 37x53 image, the counts
   zeroed before one application that must launch the op's kernel once a
   shard and nothing else, the valid values equal to the unsharded
   session's (tolerance 0); then the CLI with the counts zeroed before
   each run: ``--shards 1 --pipeline --exec`` (uint8), ``--shards 2
   --verify --pipeline --fuse`` C1 or C2 in each model (16 rows, every
   kernel of the path launched a multiple of N times; ``--exec`` in
   uint8, each slope resolved, each graph held to K direct calls),
   ``--path library --shards 2 --verify --pipeline`` (no port kernel);
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
   [8s] ``models.wide.apply_streaming`` on the benchmark image for the 13
   columns of ``WIDE_COLS`` in both models, in blocks of 512 and 1167 rows
   (``STREAM_BLOCKS``; the second folds a 2-row remainder): the stitched
   output equal to the whole-image op on the card (tolerance 0), the counts
   zeroed before each call and equal to the op's own launches times the
   blocks; the streamed and whole-image host ms per column and the host
   bake's share of the streamed time;
   [8t] (a) a raw planar ``TALL_SHAPE`` (6,400,000 rows, past every
   launcher's old ``gridDim.y`` cap) in each model, made on the card from a
   seeded generator: the 13 ops, C1-C4, the ``Taps`` kernel on the 5x5
   diamond and ``conv.cu``'s dense 7x7 (uint8: on both dense bodies, the
   int8 tensor cores and IMAD) and separable N 7, each equal to its plain
   version on the whole buffer (tolerance 0); (b) the CLI with
   ``--rounds 2 --verify --pipeline --fuse`` on ``TALL_CLI``'s synthetic
   fundus of each model (1,100,000 x 48 uint8, 300,000 x 48 float32, as
   PPM), every kernel of the path launched; (c) ``apply_streaming`` with
   its default blocks on those images for ``TALL_STREAMED``'s columns,
   equal to the whole-image op;
   [8o] a raw planar ``BIG_SHAPE`` (3, 36,000, 60,032) in each model, each
   plane past 2^31 elements: the 13 ops on the whole buffer, each output
   held to its plain version on three bands of 64 rows (the first, the one
   across element 2^31 of the first plane, the last) computed from the
   band and 2 rows of halo, tolerance 0, and freed before the next op;
7. prints ``{"kernels": [...]}`` (64 entries, each with its ``dtype``),
   the ``nvidia-smi`` line and, last, ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero, and without a CUDA device the
script exits 1 before printing any result. The images, the CSVs, the
build log and a summary go to ``build/chip_smoke/`` in the checkout.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import importlib.util
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
import types

# OpenCV refuses to decode an image of more than 2^20 rows unless this is
# set before it is imported; [8t]'s CLI images are taller.
os.environ.setdefault("OPENCV_IO_MAX_IMAGE_HEIGHT", str(1 << 24))

import numpy as np
import torch
import torch.nn.functional as F

from dip_benchmark_tpu_torch import cli, native, oracle, oracle_f32, spec
from dip_benchmark_tpu_torch.models import batch, chain, wide
from dip_benchmark_tpu_torch.models.pipeline import (fused_pipeline,
                                                     fused_pipeline_plain)
from dip_benchmark_tpu_torch.ops import (OPS, OPS_F32, PLAIN, PLAIN_F32, f32,
                                         kernels, window)
from dip_benchmark_tpu_torch.ops.kernels import build
from dip_benchmark_tpu_torch.ops.layout import (bake_stack, bake_stack_plain,
                                                crop_stack, crop_stack_plain)
from dip_benchmark_tpu_torch.parallel.session import ShardedBenchmarkSession
from dip_benchmark_tpu_torch.runtime import exec_timing
from dip_benchmark_tpu_torch.session import (PIPELINE_DESCRIPTION,
                                             BenchmarkSession)
from dip_benchmark_tpu_torch.utils.image import (crop_planar,
                                                 from_planar_padded,
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

# Phase 3l: the mask shapes of csrc/conv.cu's tile kernels, on pad-8
# layouts: every dense kh x kw with sides in CONV_SIDES, separable N 1 to 17
# (odd), at EDGE_IMAGES (as raw buffers of the pad-8 planar's shape where an
# image is too small for a pad-8 bake) and EDGE_BUFFERS; then, at full size,
# CONV_TIMED through the builders, timed.
CONV_PAD = 8
# [3l]'s sweep of every mask shape on each dense body: a partial 64-row
# tile and a 48-column pitch, two planes.
DENSE_SIDES_SHAPE = (2, 129, 48)
# [3l]'s sweep of every mask height on each two-pass kernel: that shape and
# one of several column blocks and 64-row tiles, three planes.
TWO_PASS_SIDES_SHAPES = (DENSE_SIDES_SHAPE, (3, 150, 1200))
CONV_SIDES = (1, 2, 3, 5, 7, 9, 17)
CONV_SEP_NS = tuple(range(1, 18))
# (label, data model, form, mask side(s) or N) timed at full size; "wide":
# the dense uint8 form with one weight outside int8 (the IMAD body);
# "rank1": a box filter that factors (rank1_box), the two-pass form
# unrounded between.
CONV_TIMED = [(f"{kind} {shape}", dtype, kind, shape)
              for dtype in ("uint8", "float32")
              for kind, shape in (("dense", (7, 7)), ("dense", (17, 17)),
                                  ("dense", (1, 17)), ("separable", 9),
                                  ("separable", 17))] + [
    (f"{kind} {shape}", "uint8", kind, shape)
    for kind in ("wide", "rank1") for shape in ((7, 7), (17, 17), (1, 17))]
# kernel -> (file:line and name of the TPU kernel it replaces).
CONV_TPU = {
    "conv_tile_dense_u8": ("ops/pallas/window.py:491",
                           "make_convolution (body_packed :562, body_i32 "
                           ":581, any acc_dtype), shapes past 3x3, 5x5, "
                           "a weight outside int8"),
    "conv_tile_dense_mma_u8": ("ops/pallas/window.py:491",
                               "make_convolution (body_packed :562, "
                               "body_i32 :581, any acc_dtype), shapes past "
                               "3x3, 5x5, every weight in int8"),
    "conv_tile_two_pass_u8": ("ops/pallas/window.py:606",
                              "make_convolution_separated_fused (every N "
                              "but 3, 5); make_convolution body_rank1 :541"),
    "conv_tile_dense_f32": ("ops/pallas/f32.py:133",
                            "_make_conv, shapes past 3x3, 5x5"),
    "conv_tile_sep_f32": ("ops/pallas/f32.py:160",
                          "_make_conv_sep, every N but 3, 5"),
}

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


def conv_edge_inputs(rng, dtype: str) -> list:
    """(label, planar on the CPU) at EDGE_IMAGES on pad-8 layouts (an image
    too small for one: a raw buffer of that planar's shape) and
    EDGE_BUFFERS; random data, floats in [0, 1) for float32."""
    shapes = []
    for h, w in EDGE_IMAGES:
        if min(h, w) > CONV_PAD:
            layout = make_layout(h, w, pad=CONV_PAD)
            img = rng.integers(0, 256, (h, w, 3), np.uint8)
            bake = (to_planar_padded if dtype == "uint8"
                    else to_planar_padded_f32)
            shapes.append((f"{h}x{w}", bake(img, layout)))
        else:
            shapes.append((f"{h}x{w} raw", (3, h + 2 * CONV_PAD,
                                            -(-(w + 2 * CONV_PAD) // 16)
                                            * 16)))
    shapes += [(f"raw {shape}", shape) for shape in EDGE_BUFFERS]
    out = []
    for label, x in shapes:
        if isinstance(x, tuple):
            x = torch.from_numpy(
                rng.integers(0, 256, x, np.uint8) if dtype == "uint8"
                else rng.random(x, dtype=np.float32))
        out.append((label, x))
    return out


def smooth_weights(rng, kh: int, kw: int, anchor: int = 16) -> tuple:
    """(mask, shift): nonnegative weights summing to about 1 << shift (a
    user's smoothing filter), ``anchor`` more at the anchor. The default
    weights (8 to 55) fit int8; an anchor of 200 puts one outside it."""
    m = rng.integers(8, 40, (kh, kw)).astype(np.int32)
    m[kh // 2, kw // 2] += anchor
    return m, int(round(np.log2(m.sum())))


def rank1_box(kh: int, kw: int) -> tuple:
    """(u, v) of a kh x kw box filter, every other column of it where the
    whole box would pass the packed-16 bound (255 sum < 2^16) that sends a
    factoring mask to the two-pass form unrounded between."""
    u, v = np.ones(kh, np.int32), np.ones(kw, np.int32)
    if 255 * kh * kw >= 1 << 16:
        v[1::2] = 0
    return u, v


def smooth_mask(rng, kh: int, kw: int, anchor: int = 16) -> tuple:
    """``smooth_weights`` whose sum is past the packed-16 bound, so that
    the mask takes the dense form, as a row mask 1xN must to."""
    m, shift = smooth_weights(rng, kh, kw, anchor)
    check(window.rank1_factors(m) is None, f"{m.tolist()} takes rank 1")
    return m, shift


def conv_tile_cases(rng) -> list:
    """(label, data model, kernel name, op on a planar tensor, its plain
    version) for [3l]: every dense shape of CONV_SIDES in both models
    (random weights of either sign), factoring masks (the two-pass form
    unrounded between), separable N in CONV_SEP_NS in both models, an
    acc_dtype, and masks whose int32 sums wrap."""
    cases = []

    def u8(label, mask, shift, acc=None):
        name = window.convolution_launch(mask, shift, acc)[0]
        cases.append((label, "uint8", name,
                      lambda p, m=mask, s=shift, a=acc: window.convolution(
                          p, m, s, a),
                      lambda p, m=mask, s=shift, a=acc:
                      window.convolution_plain(p, m, s, a)))

    for kh in CONV_SIDES:
        for kw in CONV_SIDES:
            u8(f"{kh}x{kw}", rng.integers(-40, 90, (kh, kw)).astype(
                np.int32), int(rng.integers(3, 9)))
            wide = rng.integers(-40, 90, (kh, kw)).astype(np.int32)
            wide[kh // 2, kw // 2] = 200 if (kh + kw) % 2 else -200
            u8(f"{kh}x{kw}, a weight outside int8", wide,
               int(rng.integers(5, 10)))
            fm = rng.integers(-1000, 1001, (kh, kw)).astype(np.int32)
            cases.append((f"{kh}x{kw}", "float32",
                          f32.convolution_launch(fm, 10)[0],
                          lambda p, m=fm: f32.convolution(p, m, 10),
                          lambda p, m=fm: f32.conv_dense_plain(p, m, 10)))
    for kh, kw in ((7, 5), (2, 9), (1, 17), (17, 17)):
        u, v = rng.integers(0, 2, kh), rng.integers(0, 2, kw)
        u[kh // 2], v[kw // 2] = 1, 1
        u8(f"rank 1 {kh}x{kw}", np.outer(u, v).astype(np.int32),
           int(rng.integers(1, 6)))
    for kh, kw in ((9, 3), (1, 17), (17, 17)):
        ends = np.resize(np.array([-128, 127, 127, -128, 5]), (kh, kw))
        u8(f"int8 ends {kh}x{kw}", ends.astype(np.int32), 8)
    u8("acc_dtype int32 7x7", np.outer([1, 2, 3, 4, 3, 2, 1],
                                       [1, 1, 2, 2, 2, 1, 1]).astype(
        np.int32), 6, "int32")
    for label, mask, shift in (
            ("wraps, either sign, 5x5", np.where(
                np.arange(25).reshape(5, 5) % 3, 1 << 24, -(1 << 23)), 4),
            ("wraps, either sign, 3x3", np.full((3, 3), 3 << 24) * np.array(
                [1, -1, 1]), 20),
            ("wraps, no clamp, 9x9 >> 31", np.full((9, 9), 1 << 23), 31)):
        u8(label, mask.astype(np.int32), shift)
    for n in CONV_SEP_NS:
        for dtype, mod in (("uint8", window), ("float32", f32)):
            lo, hi, shift = (-6, 9, 3) if dtype == "uint8" else (
                -1000, 1001, 10)
            row = rng.integers(lo, hi, (1, n)).astype(np.int32)
            col = rng.integers(lo, hi, (n, 1)).astype(np.int32)
            cases.append((f"separable {n}", dtype,
                          mod.convolution_separated_launch(row, col,
                                                           shift)[0],
                          lambda p, r=row, c=col, s=shift, m=mod:
                          m.convolution_separated(p, r, c, s),
                          lambda p, r=row, c=col, s=shift, m=mod:
                          m.conv_sep_plain(p, r, c, s)))
    row = np.array([[1 << 22, -(1 << 22), 3 << 21, 5, -(1 << 21)]], np.int32)
    cases.append(("separable 5, wraps", "uint8",
                  window.convolution_separated_launch(row, row.T.copy(),
                                                      3)[0],
                  lambda p: window.convolution_separated(p, row,
                                                         row.T.copy(), 3),
                  lambda p: window.conv_sep_plain(p, row, row.T.copy(), 3)))
    return cases


def compare_dense_sides(rng, shape=DENSE_SIDES_SHAPE) -> dict:
    """[3l] (a): every kh x kw of 1..17 (but the strip bodies' 3x3 and 5x5)
    on each dense body, so that each of its instantiations runs: uint8
    with int8 weights (the mma body, compiled per height) and with one
    weight of +-200 (IMAD, per width), both in the dense form
    (``acc_dtype``), float32 (per height); random data on the card,
    against the plain version, tolerance 0. The largest |kernel - plain|
    per kernel name."""
    planars = {
        "uint8": torch.from_numpy(rng.integers(0, 256, shape,
                                               np.uint8)).cuda(),
        "float32": torch.from_numpy(rng.random(shape,
                                               dtype=np.float32)).cuda()}
    errs = {}
    sides = range(1, window.MAX_CONV_SIDE + 1)
    for kh in sides:
        for kw in sides:
            if kh == kw and kh in window.STRIP_CONV_SIZES:
                continue
            mma = rng.integers(-128, 128, (kh, kw)).astype(np.int32)
            wide = rng.integers(-40, 90, (kh, kw)).astype(np.int32)
            wide[rng.integers(kh), rng.integers(kw)] = rng.choice([-200, 200])
            fm = rng.integers(-1000, 1001, (kh, kw)).astype(np.int32)
            shift = int(rng.integers(4, 12))
            for want, dtype, launch, fn, plain in (
                    ("conv_tile_dense_mma_u8", "uint8",
                     window.convolution_launch(mma, shift, "int32"),
                     lambda p: window.convolution(p, mma, shift, "int32"),
                     lambda p: window.conv_dense_plain(p, mma, shift)),
                    ("conv_tile_dense_u8", "uint8",
                     window.convolution_launch(wide, shift, "int32"),
                     lambda p: window.convolution(p, wide, shift, "int32"),
                     lambda p: window.conv_dense_plain(p, wide, shift)),
                    ("conv_tile_dense_f32", "float32",
                     f32.convolution_launch(fm, 10),
                     lambda p: f32.convolution(p, fm, 10),
                     lambda p: f32.conv_dense_plain(p, fm, 10))):
                check(launch[0] == want, f"{kh}x{kw} {dtype} takes "
                      f"{launch[0]}, not {want}")
                got, want_out = fn(planars[dtype]), plain(planars[dtype])
                torch.cuda.synchronize()
                err = max_delta(got, want_out)
                errs[want] = max(errs.get(want, 0.0), err)
                check(torch.equal(got, want_out), f"{want} {kh}x{kw} on "
                      f"{tuple(shape)}: kernel differs from its plain "
                      f"version (max |delta| {err})")
    return errs


def two_pass_side_cases(rng) -> list:
    """(label, kernel name, launch, plain version, body) for every
    instantiation of csrc/conv.cu's two-pass kernels: for each N of 1..17
    (3 and 5 too, which the builders send to the strip bodies, so the C
    entry points are called directly) uint8 rounded between the passes
    (clamped, and whole where the masks cannot leave [0, 255]), the
    unrounded N x N rank-1 form and an unrounded N x kw one with kw != N
    (the row pass of any width), each with row weights of 1, 2 and more
    base-256 digits (the last with the column pass in uint32), and float32.
    ``body``: kh and ``window.two_pass_body``'s (None for float32)."""
    cases = []

    def u8(label, u, v, shift, rnd, plain):
        clamp_rows = bool(rnd and window.clamps(v, shift))
        name, entry, extra = window.two_pass_launch(
            u, v, shift, rnd, clamp_rows,
            not rnd or window.clamps(u, shift))
        cases.append((label, name, lambda p: window._launch_window(
            name, entry, p, *extra), plain,
            (len(u), *window.two_pass_body(u, v, shift, rnd, clamp_rows))))

    def big(rng, n, at):
        # Small weights, one of them `at` (2 digits: 200; 3: 40000).
        w = rng.integers(0, 4, n).astype(np.int32)
        w[rng.integers(n)] = at
        return w

    for n in range(1, window.MAX_CONV_SIDE + 1):
        row = rng.integers(-6, 9, (1, n)).astype(np.int32)
        col = rng.integers(-6, 9, (n, 1)).astype(np.int32)
        u8(f"u8 separable {n}", col, row, 3, True,
           lambda p, r=row, c=col: window.conv_sep_plain(p, r, c, 3))
        pos = rng.integers(0, 5, (1, n)).astype(np.int32)
        shift = int(np.ceil(np.log2(max(int(pos.sum()), 1))))
        u8(f"u8 separable {n}, no clamp", pos.T.copy(), pos, shift, True,
           lambda p, r=pos, s=shift: window.conv_sep_plain(p, r, r.T.copy(),
                                                           s))
        for at, cat in ((200, 3), (40000, 70000)):
            row, col = big(rng, n, at)[None], big(rng, n, cat)[:, None]
            u8(f"u8 separable {n}, a row weight of {at}", col, row, 8, True,
               lambda p, r=row, c=col: window.conv_sep_plain(p, r, c, 8))
        kw = (7 * n) % window.MAX_CONV_SIDE + 1
        kw = kw if kw != n else n % window.MAX_CONV_SIDE + 1
        for w in (n, kw):
            for at in (None, 200, 40000):
                u = rng.integers(0, 4, n)
                v = rng.integers(0, 4, w) if at is None else big(rng, w, at)
                shift = int(rng.integers(1, 7))
                u8(f"u8 rank 1 {n}x{w}" + (f", a weight of {at}" if at
                                           else ""), u, v, shift, False,
                   lambda p, u=u, v=v, s=shift: window.conv_rank1_plain(
                       p, u, v, s))
        frow = rng.integers(-1000, 1001, (1, n)).astype(np.int32)
        fcol = rng.integers(-1000, 1001, (n, 1)).astype(np.int32)
        extra = (n, f32._float_array(spec.mask_float(frow, 10)),
                 f32._float_array(spec.mask_float(fcol, 10)))
        cases.append((f"f32 separable {n}", "conv_tile_sep_f32",
                      lambda p, e=extra: window._launch_window(
                          "conv_tile_sep_f32", "dip_conv_tile_sep_f32", p,
                          *e),
                      lambda p, r=frow, c=fcol: f32.conv_sep_plain(p, r, c,
                                                                   10),
                      None))
    return cases


def compare_two_pass_sides(rng, shape=DENSE_SIDES_SHAPE) -> dict:
    """[3l] (a): ``two_pass_side_cases`` on random data of ``shape`` on the
    card (uint8, and float32 in [0, 1)), each against its plain version,
    tolerance 0. The largest |kernel - plain| per kernel name."""
    planars = {
        "uint8": torch.from_numpy(rng.integers(0, 256, shape,
                                               np.uint8)).cuda(),
        "float32": torch.from_numpy(rng.random(shape,
                                               dtype=np.float32)).cuda()}
    errs = {}
    cases = two_pass_side_cases(rng)
    bodies = {(n, square, digits, fl) for n in range(
        1, window.MAX_CONV_SIDE + 1) for square in (True, False)
        for digits, fl in ((1, True), (2, True), (4, False))}
    ran = {body for *_, body in cases if body}
    check(ran == bodies, f"[3l] two-pass cases miss the uint8 "
          f"instantiations {sorted(bodies - ran)}")
    for label, name, fn, plain, _ in cases:
        planar = planars["float32" if label.startswith("f32") else "uint8"]
        got, want = fn(planar), plain(planar)
        torch.cuda.synchronize()
        err = max_delta(got, want)
        errs[name] = max(errs.get(name, 0.0), err)
        check(torch.equal(got, want), f"{name} ({label}) on {tuple(shape)}:"
              f" kernel differs from its plain version (max |delta| {err})")
    return errs


def compare_conv_tiles(rng) -> dict:
    """[3l] (a): every case of conv_tile_cases against its plain version
    on the whole buffer, tolerance 0, at the edge inputs of its data
    model; the largest |kernel - plain| per kernel name."""
    cases = conv_tile_cases(rng)
    for name in CONV_TPU:
        check(any(c[2] == name for c in cases), f"no [3l] case runs {name}")
    errs = {}
    for dtype in ("uint8", "float32"):
        mine = [c for c in cases if c[1] == dtype]
        for label, planar in conv_edge_inputs(rng, dtype):
            planar = planar.cuda()
            for what, _, name, fn, plain in mine:
                got, want = fn(planar), plain(planar)
                torch.cuda.synchronize()
                err = max_delta(got, want)
                errs[name] = max(errs.get(name, 0.0), err)
                check(torch.equal(got, want), f"{name} ({what}) on {label} "
                      f"{tuple(planar.shape)}: kernel differs from its "
                      f"plain version (max |delta| {err})")
            print(f"  {dtype} {label} {tuple(planar.shape)}: {len(mine)} "
                  f"convolutions equal to their plain versions")
    return errs


def conv_timed_ops(rng, layout) -> list:
    """(label, data model, op built on ``layout``, plain version, mask,
    shift) for each of CONV_TIMED: the dense masks from smooth_mask (not
    rank 1), the rank-1 ones from rank1_box over about their sum, the
    separable ones a binomial row over 2^(N-1)."""
    ops = []
    for label, dtype, kind, shape in CONV_TIMED:
        if kind == "rank1":
            mask = np.outer(*rank1_box(*shape)).astype(np.int32)
            shift = int(round(math.log2(int(mask.sum()))))
            op = window.make_convolution(layout, *shape, shift, mask)
            plain = (lambda p, m=mask, s=shift:
                     window.convolution_plain(p, m, s))
        elif kind in ("dense", "wide"):
            mask, shift = smooth_mask(rng, *shape,
                                      anchor=200 if kind == "wide" else 16)
            if dtype == "uint8":
                op = window.make_convolution(layout, *shape, shift, mask)
                plain = (lambda p, m=mask, s=shift:
                         window.conv_dense_plain(p, m, s))
            else:
                op = f32.make_conv(layout, mask, shift)
                plain = lambda p, m=mask, s=shift: f32.conv_dense_plain(
                    p, m, s)
        else:
            mask = np.array([[math.comb(shape - 1, k) for k in range(shape)]],
                            np.int32)
            shift = shape - 1
            mod = window if dtype == "uint8" else f32
            build = (window.make_convolution_separated_fused
                     if dtype == "uint8" else f32.make_conv_sep)
            op = build(layout, shape, mask, shift)
            plain = lambda p, m=mask, s=shift, md=mod: md.conv_sep_plain(
                p, m, m.T.copy(), s)
        ops.append((label, dtype, op, plain, mask, shift))
    return ops


def conv_oracle(dtype: str, kind: str, img, mask, shift):
    """The oracle's HWC crop of one CONV_TIMED op on ``img``."""
    if dtype == "uint8":
        if kind in ("dense", "wide", "rank1"):
            return oracle.convolution(img, mask, shift)
        return oracle.convolution(oracle.convolution(img, mask, shift),
                                  mask.T.copy(), shift)
    x = oracle_f32.from_uint8_hwc(img)
    if kind == "dense":
        y = oracle_f32.convolution(x, mask, shift)
    else:
        y = oracle_f32.convolution(oracle_f32.convolution(x, mask, shift),
                                   mask.T.copy(), shift)
    return np.ascontiguousarray(np.transpose(y, (1, 2, 0)))


def drive_conv_tiles(img, small) -> tuple[dict, list, dict]:
    """[3l] (b): the builders of CONV_TIMED on the pad-8 planar of the
    full-size image, driven once with the counts zeroed (each kernel of
    CONV_TPU launched, nothing else); every output equal to its plain
    version on the whole buffer (tolerance 0). Then the same builders on
    ``small``: the crops equal to the oracle (float32 too: the kernels
    keep its order of sums, and it starts from 0.0). Returns the counts,
    the ops on the full-size layout and the largest |kernel - plain| per
    kernel."""
    layout = make_layout(*img.shape[:2], pad=CONV_PAD)
    planars = {"uint8": to_planar_padded(img, layout).cuda(),
               "float32": to_planar_padded_f32(img, layout).cuda()}
    ops = conv_timed_ops(np.random.default_rng(12), layout)
    torch.cuda.synchronize()
    kernels.reset_launches()
    outs = [op(planars[dtype]) for _, dtype, op, *_ in ops]
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    check(set(counts) == set(CONV_TPU) and min(counts.values()) >= 1,
          f"[3l] builders launched {counts}, want each of {sorted(CONV_TPU)}")
    errs = {}
    for (label, dtype, op, plain, *_), out in zip(ops, outs):
        err = max_delta(out, plain(planars[dtype]))
        errs[op.kernel] = max(errs.get(op.kernel, 0.0), err)
        check(err == 0, f"{op.kernel} ({label}) at full size: kernel "
              f"differs from its plain version (max |delta| {err})")
    small_layout = make_layout(*small.shape[:2], pad=CONV_PAD)
    small_ops = conv_timed_ops(np.random.default_rng(12), small_layout)
    for (label, dtype, op, _, mask, shift), (*_, kind, _) in zip(
            small_ops, CONV_TIMED):
        bake = (to_planar_padded if dtype == "uint8"
                else to_planar_padded_f32)
        got = from_planar_padded(op(bake(small, small_layout).cuda()),
                                 small_layout)
        want = conv_oracle(dtype, kind, small, mask, shift)
        check(np.array_equal(got, want), f"{op.kernel} ({label}) on "
              f"{small.shape[:2]}: crop differs from the oracle (max "
              f"|delta| {np.abs(got.astype(float) - want).max()})")
    print(f"  {img.shape[0]}x{img.shape[1]} on pad {CONV_PAD} "
          f"{tuple(planars['uint8'].shape)}: {len(ops)} builders, counts "
          f"zeroed: launches {counts}; each output equal to its plain "
          f"version; on {small.shape[0]}x{small.shape[1]} each crop equal "
          f"to the oracle")
    return counts, ops, errs


def conv_work(dtype: str, kind: str, shape):
    """WORK or WORK_F32 of one CONV_TIMED op a position of the plane, all
    three planes: multiply-adds and rounding steps (uint8), or float32
    multiplies and adds. A rank-1 mask's two passes: kh + kw taps, one
    rounding."""
    dense = kind in ("dense", "wide")
    taps = (shape[0] * shape[1] if dense else sum(shape) if kind == "rank1"
            else 2 * shape)
    rounds = 2 if kind == "separable" else 1
    if dtype == "uint8":
        return (3 * taps, 9 * rounds)
    return 3 * (2 * taps - rounds)


def time_conv_tiles(img, ops, counts: dict, errs: dict) -> list[dict]:
    """[3l] (b): kernel, plain and (float32) one depthwise F.conv2d device
    time of each CONV_TIMED op at full size, beside its bound; one
    ``{"kernels": [...]}`` entry each."""
    layout = make_layout(*img.shape[:2], pad=CONV_PAD)
    planars = {"uint8": to_planar_padded(img, layout).cuda(),
               "float32": to_planar_padded_f32(img, layout).cuda()}
    entries = []
    for (label, dtype, op, plain, mask, shift), (*_, kind, shape) in zip(
            ops, CONV_TIMED):
        planar = planars[dtype]
        versions = [op, plain]
        if dtype == "float32":
            lib = (_depthwise(spec.mask_float(mask, shift)) if kind == "dense"
                   else _separable(mask, mask.T.copy(), shift))
            got, want = lib(planar), plain(planar)
            r0 = (want.shape[-2] - got.shape[-2]) // 2
            c0 = (want.shape[-1] - got.shape[-1]) // 2
            want = want[:, r0:r0 + got.shape[-2], c0:c0 + got.shape[-1]]
            # Within 4 ulps a term of the sum of |weights|: F.conv2d sums
            # in another order, and the separable pair as one dense mask.
            total = float(np.abs(spec.mask_float(mask, shift)).sum())
            terms, total = ((mask.size, total) if kind == "dense" else
                            (mask.size ** 2 + 2 * mask.size, total ** 2))
            tol = 4 * terms * 2.0 ** -24 * total
            err = max_delta(got, want)
            check(err <= tol, f"library {label} is {err} from the plain "
                              f"version (tolerance {tol}; TF32 on?)")
            versions.append(lib)
        ms, plain_ms, *lib_ms = timed(versions, planar)
        library_ms = lib_ms[0] if lib_ms else None
        bound_ms, bound_by = bound_for(conv_work(dtype, kind, shape),
                                       planar)
        lib_txt = ("none" if library_ms is None
                   else f"{library_ms:9.4f} ms (conv2d)")
        print(f"    {dtype:7s} {label:18s} {op.kernel:22s} kernel {ms:9.4f}"
              f" ms | plain {plain_ms:9.4f} ms | library {lib_txt} | bound "
              f"{bound_ms:.4f} ms ({bound_by})")
        where, tpu_name = CONV_TPU[op.kernel]
        entries.append({
            "name": op.kernel, "dtype": dtype, "op": label, "route": "cuda",
            "source": CSRC + "conv.cu", "replaces": "dip_benchmark_tpu/"
            + where, "tpu_kernel": tpu_name,
            "launches": counts.get(op.kernel, 0),
            "max_abs_err": errs.get(op.kernel, 0.0), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms})
    return entries


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
    version) for every body of window_f32_strip: the 3x3 erosions by the
    cross and the square and the separated one, the blur, the matrix's
    masks and random ones (ints of up to 10 bits over 2^10, so that most
    products round), ``ConvSep`` with random row and column masks; and the
    float32 ``Taps`` kernel on the elements of ``MORPHOLOGY``."""
    out = [(label, name, lambda p, m=mask: f32.erosion(p, m),
            lambda p, m=mask: window.erosion_plain(p, m))
           for label, (mask, name, _) in zip(("cross", "square"),
                                             f32.EROSION_KERNELS)]
    out += [("separated", "window_f32<MinSep>", f32.erosion_separated,
             window.erosion_sep_plain),
            ("Blur3x3", "window_f32<Blur3x3>", f32.gaussian_blur_3x3,
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
                    name: str = "benchmark-image", extra=(),
                    ext: str = ".png") -> tuple[dict, dict]:
    """Run the port's CLI once on ``img`` (saved as ``name`` + ``ext``)
    with ``--verify``, the pipeline row and the chain ``fuse`` in
    ``model``'s data model, and ``extra`` flags; return that run's launch
    counts and its rows' µs a round (``row_us``)."""
    tag = "-".join([name, model.dtype, *extra]).replace("--", "")
    dumps = fresh("dumps-" + tag)
    csv = fresh(f"results-{tag}.csv")
    path = save_benchmark_image(img, name, ext)
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
    names = [f"{p}-{name}{ext}" for p in prefixes]
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
    if kernel is None:
        check(not counts, f"batch tool --op {cols} launched port kernels "
                          f"{counts}; the library path launches none")
    else:
        # One launch of each kernel a chunk (models/batch.chunks) of each
        # batch of 8 of each shape group.
        per_shape = collections.Counter(img.shape for img in named.values())
        chunks = sum(len(batch.chunks((min(8, n - i),) + shape))
                     for shape, n in per_shape.items()
                     for i in range(0, n, 8))
        for name in ("bake_u8", kernel, "crop_u8"):
            check(counts.get(name, 0) == chunks,
                  f"batch tool launched {name} {counts.get(name)} times, "
                  f"want one per chunk of each shape group ({chunks})")
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


def save_benchmark_image(img, name: str = "benchmark-image",
                         ext: str = ".png") -> str:
    path = os.path.join(OUT, name + ext)
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
    the host share of each kernel's rounds split by host_share.py, and
    each round's idle time by the port's span the host was in."""
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
    print(f"  idle µs a round by the port's span open on the host (means; "
          f"off by up to the clock skew, median {skew[1]:.1f} µs):")
    print("    kernel | idle | " + " | ".join(host_share.SPAN_COLUMNS))
    for r in rows:
        by = r["idle_by_span"]
        parts = sum(by.values())
        check(abs(parts - r["idle_us"]) <= 0.01 * r["idle_us"],
              f"{r['kernel']}: idle_by_span's parts sum to {parts:.2f} "
              f"µs, its idle time is {r['idle_us']:.2f}")
        print(f"    {r['kernel']} | {r['idle_us']:.1f} | " + " | ".join(
            f"{by.get(c, 0.0):.1f}" for c in host_share.SPAN_COLUMNS))
    return rows



# [4s] Row sharding: the CLI's --shards on the card, and the shard counts
# whose crops are held to the unsharded session in process (3 pads the
# benchmark image's 2336 rows to 2337 + 1 + 3, the row-padding rule).
SHARDS = (2,)    # the CLI runs; the crops of 2, 3 and 4 shards are held above
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
    """[4s] The CLI at --shards 1 (uint8, --exec) and 2 (--verify
    --pipeline --fuse, every kernel of the path launched; --exec in
    uint8), and --path library --shards 2 --verify (no port kernel)."""
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
    library = drive_sharded_cli(models[0], img, 2, [
        "--path", "library", "--verify", "--pipeline"])
    check(not library["launches"] and len(library["rows"]) == 15,
          f"--path library --shards 2: launches {library['launches']}, "
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
    at --shards 1 and 2 (``--verify --pipeline --fuse`` at 2, each
    kernel of the path launched; ``--exec`` in uint8), ``--path library
    --shards 2 --verify``, and the batch tool on a 2x2 mesh."""
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
    print(f"  library path, --shards 2 --verify: rc 0, 15 rows, no port "
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


# [8s] Row-block streaming (models/wide.apply_streaming) on the benchmark
# image: blocks of 512 rows (4 x 512 and 288 at 2336 rows) and of 1167 (its
# 2-row remainder folds into the last block: 1167 + 1169).
STREAM_BLOCKS = (512, 1167)
# [8t] Heights past every launcher's old gridDim.y cap of 65,535 row
# blocks: chain_u8's 96 rows a block capped it at 6,291,360 padded rows,
# the most of any, so TALL_SHAPE, a raw planar at a narrow pitch, passes
# them all. The CLI's images pass window_u8_strip's old cap (1,048,560
# rows) in uint8 and window_f32_strip's (262,140) in float32; OpenCV reads
# them only with OPENCV_IO_MAX_IMAGE_HEIGHT raised (top of this file), and
# PNG holds no more than 2^20 rows for it, so they travel as PPM.
TALL_SHAPE = (3, 6_400_000, 32)
TALL_CLI = {"uint8": (1_100_000, 48), "float32": (300_000, 48)}
TALL_STREAMED = (("float32", "Convolution-5x5"),
                 ("float32", "Erosion-3x3-Square"),
                 ("uint8", "Fused-Pipeline"))
# [8o] Planes past 2^31 elements: 36,000 x 60,032 is 2,161,152,000 bytes a
# uint8 plane, and as many floats (8.6 GB) a float32 one. The kernels run
# on the whole buffer; their plain versions on crops with a halo of
# BAND_HALO rows: the first BAND_ROWS rows, the band across element 2^31 of
# the first plane, the last BAND_ROWS.
BIG_SHAPE = (3, 36_000, 60_032)
BAND_ROWS, BAND_HALO = 64, 2


def whole_image(model: Model, img, col: str) -> tuple[np.ndarray, float]:
    """The whole-image op on the card in apply_streaming's output form
    (uint8 HWC, or the float32 (C, H, W) crop unquantised), and the host
    ms of bake, copy, op and crop."""
    t0 = time.perf_counter()
    layout = make_layout(*img.shape[:2])
    out = model.ops[col](model.bake(img, layout).cuda())
    want = (from_planar_padded(out, layout) if model.dtype == "uint8"
            else crop_planar(out, layout))
    return want, 1e3 * (time.perf_counter() - t0)


@contextlib.contextmanager
def timed_bakes(bake_ms: list):
    """Add the host ms of every block bake that apply_streaming makes
    inside the block to ``bake_ms``."""
    names = ("to_planar_padded", "to_planar_padded_f32")
    real = {name: getattr(wide, name) for name in names}

    def timed(fn):
        def bake(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            bake_ms.append(1e3 * (time.perf_counter() - t0))
            return out
        return bake
    for name in names:
        setattr(wide, name, timed(real[name]))
    try:
        yield bake_ms
    finally:
        for name in names:
            setattr(wide, name, real[name])


def streamed(model: Model, img, col: str, block_rows: int,
             per_application: dict) -> tuple[np.ndarray, float, float]:
    """apply_streaming with the counts zeroed: its output, its host ms and
    the ms of its host bakes, and a check that it launched the op's
    kernels once a block."""
    blocks = len(wide.block_starts(img.shape[0], block_rows)[1])
    kernels.reset_launches()
    with timed_bakes([]) as bake_ms:
        t0 = time.perf_counter()
        got = wide.apply_streaming(img, col, block_rows, model.dtype,
                                   torch.device("cuda"))
        ms = 1e3 * (time.perf_counter() - t0)
    counts = dict(kernels.LAUNCHES)
    want = {k: blocks * n for k, n in per_application.items()}
    check(counts == want, f"[8s] {model.dtype} {col} in blocks of "
          f"{block_rows}: launches {counts}, want {want}")
    return got, ms, sum(bake_ms)


def drive_streaming(models, img, label, smi) -> dict:
    """[8s] apply_streaming for every column of WIDE_COLS in both models
    in blocks of STREAM_BLOCKS: the stitched output equal to the
    whole-image op on the card (tolerance 0), the launches the op's own
    times the blocks; the streamed and whole-image host ms, and the share
    of the streamed time that the host bake of the blocks takes."""
    t0 = time.perf_counter()
    h, w = img.shape[:2]
    layout = make_layout(h, w)
    rows = []
    for model in models:
        planar = model.bake(img, layout).cuda()
        for col in wide.WIDE_COLS:
            want, whole_ms = whole_image(model, img, col)
            kernels.reset_launches()
            model.ops[col](planar)
            per_app = dict(kernels.LAUNCHES)
            row = {"dtype": model.dtype, "col": col, "whole_ms": whole_ms,
                   "launches": per_app}
            for block_rows in STREAM_BLOCKS:
                got, ms, bake_ms = streamed(model, img, col, block_rows,
                                            per_app)
                check(got.dtype == want.dtype and np.array_equal(got, want),
                      f"[8s] {model.dtype} {col} in blocks of {block_rows} "
                      f"differs from the whole-image op")
                row[f"ms_{block_rows}"] = ms
                row[f"bake_share_{block_rows}"] = bake_ms / ms
            rows.append(row)
        del planar
    counts = [len(wide.block_starts(h, b)[1]) for b in STREAM_BLOCKS]
    print(f"  {label}, blocks of {' and '.join(map(str, STREAM_BLOCKS))} "
          f"rows ({' and '.join(map(str, counts))} blocks): every column "
          f"equal to the whole-image op (tolerance 0), launches the op's "
          f"times the blocks | {smi}")
    print(f"    {'host ms':30s} | whole | " + " | ".join(
        f"blocks {b} (bake share)" for b in STREAM_BLOCKS))
    for r in rows:
        cells = [f"{r[f'ms_{b}']:7.1f} ({r[f'bake_share_{b}']:.2f})"
                 for b in STREAM_BLOCKS]
        print(f"    {r['dtype'] + ' ' + r['col']:30s} | "
              f"{r['whole_ms']:6.1f} | " + " | ".join(cells))
    seconds = time.perf_counter() - t0
    print(f"  [8s] took {seconds:.1f} s")
    return {"image": label, "rows": rows, "seconds": seconds}


def tall_cases(dtype: str, shape, rng) -> list:
    """(label, kernel, op, plain version) for every launcher of data model
    ``dtype`` on a raw planar of ``shape``: the 13 ops, the chains C1-C4,
    the Taps kernel on the 5x5 diamond, and csrc/conv.cu's dense 7x7 (in
    uint8 on both dense bodies) and separable N 7."""
    f32m = dtype == "float32"
    ops, plain, names = ((OPS_F32, PLAIN_F32, KERNELS_F32) if f32m
                         else (OPS, PLAIN, KERNELS))
    cases = [(col, names[col][0], ops[col], plain[col]) for col in ops]
    for name, cols in CHAINS.items():
        cases.append((name, CHAIN_KERNELS[dtype][0],
                      raw_chain(shape, cols, dtype=dtype),
                      lambda p, c=cols: chain.fused_chain_plain(p, c,
                                                                dtype)))
    taps = window.mask_to_taps(DIAMOND_5X5)
    name, entry, extra = window.morphology_launch(taps, "min", dtype)
    cases.append(("Erosion-5x5-Diamond", name,
                  lambda p: window._launch_window(name, entry, p, *extra),
                  lambda p: window.morphology_plain(p, taps, torch.minimum)))
    mod = f32 if f32m else window
    # uint8: weights that fit int8 (the mma body) and one of 200 (IMAD).
    for label, anchor in (("dense 7x7", 16),) + (
            () if f32m else (("dense 7x7, a weight outside int8", 200),)):
        dense, shift = smooth_mask(rng, 7, 7, anchor=anchor)
        cases.append((label, mod.convolution_launch(dense, shift)[0],
                      lambda p, m=dense, s=shift: mod.convolution(p, m, s),
                      lambda p, m=dense, s=shift: (
                          mod.conv_dense_plain if f32m
                          else mod.convolution_plain)(p, m, s)))
    row = rng.integers(-6, 9, (1, 7)).astype(np.int32)
    col = rng.integers(-6, 9, (7, 1)).astype(np.int32)
    cases.append(("separable 7",
                  mod.convolution_separated_launch(row, col, 3)[0],
                  lambda p: mod.convolution_separated(p, row, col, 3),
                  lambda p: mod.conv_sep_plain(p, row, col, 3)))
    return cases


def random_planar(shape, dtype: str, seed: int) -> torch.Tensor:
    """A raw planar on the card from a seeded generator on the card:
    uint8 bytes, or float32 in [0, 1)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    if dtype == "uint8":
        x = torch.empty(shape, dtype=torch.uint8, device="cuda")
        return x.random_(0, 256, generator=g)
    x = torch.empty(shape, dtype=torch.float32, device="cuda")
    return x.uniform_(0, 1, generator=g)


def check_tall(dtype: str, shape, seed: int = 8) -> dict:
    """[8t] (a): every case of ``tall_cases`` on a raw planar of ``shape``
    made on the card, kernel against plain version on the whole buffer,
    tolerance 0; the largest |kernel - plain| per kernel."""
    planar = random_planar(shape, dtype, seed)
    errs = {}
    for what, name, fn, plain in tall_cases(dtype, shape,
                                            np.random.default_rng(seed)):
        got = fn(planar)
        want = plain(planar)
        torch.cuda.synchronize()
        err = max_delta(got, want)
        errs[name] = max(errs.get(name, 0.0), err)
        check(torch.equal(got, want), f"[8t] {name} ({what}) on a {dtype} "
              f"{tuple(shape)} planar: kernel differs from its plain "
              f"version (max |delta| {err})")
        del got, want
    return errs


def drive_tall(models, smi) -> dict:
    """[8t] (a) every launcher on TALL_SHAPE in both models; (b) the CLI
    with --verify --pipeline --fuse on TALL_CLI's image of each model; (c)
    apply_streaming with its default blocks on those images for the
    columns of TALL_STREAMED, each equal to the whole-image op."""
    t0 = time.perf_counter()
    errs = {}
    for model in models:
        errs[model.dtype] = check_tall(model.dtype, TALL_SHAPE)
        print(f"  (a) {model.dtype} raw planar {TALL_SHAPE}: "
              f"{len(errs[model.dtype])} kernels (13 ops, C1-C4, a Taps "
              f"element, conv.cu's shapes) equal to their plain versions, "
              f"tolerance 0")
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    runs = []
    by_dtype = {m.dtype: m for m in models}
    images = {}
    for model in models:
        h, w = TALL_CLI[model.dtype]
        img = synth_fundus(h, w)
        images[model.dtype] = img
        label = f"synth_fundus({h}x{w})"
        t2 = time.perf_counter()
        counts, rows = drive_main_path(
            model, img, label, MAIN_CHAINS[model.dtype], rounds=2,
            name="tall", ext=".ppm")
        runs.append({"dtype": model.dtype, "image": label, "rows": rows,
                     "launches": counts,
                     "seconds": time.perf_counter() - t2})
    print(f"  (b) the CLI, --verify passed on both images; "
          f"{time.perf_counter() - t1:.1f} s")
    streamed_rows = []
    for dtype, col in TALL_STREAMED:
        model, img = by_dtype[dtype], images[dtype]
        want, whole_ms = whole_image(model, img, col)
        blocks = len(wide.block_starts(img.shape[0], 2048)[1])
        t2 = time.perf_counter()
        got = wide.apply_streaming(img, col, dtype=dtype)
        ms = 1e3 * (time.perf_counter() - t2)
        check(np.array_equal(got, want), f"[8t] apply_streaming {dtype} "
              f"{col} on {img.shape[0]}x{img.shape[1]} differs from the "
              f"whole-image op")
        streamed_rows.append({"dtype": dtype, "col": col, "blocks": blocks,
                              "ms": ms, "whole_ms": whole_ms})
        print(f"  (c) apply_streaming {dtype} {col} on {img.shape[0]}x"
              f"{img.shape[1]}, {blocks} blocks of 2048: equal to the "
              f"whole-image op; host ms {ms:.1f} (whole image "
              f"{whole_ms:.1f})")
    seconds = time.perf_counter() - t0
    print(f"  [8t] took {seconds:.1f} s | {smi}")
    return {"errs": errs, "cli": runs, "streamed": streamed_rows,
            "seconds": seconds}


def band_rows(hp: int, pitch: int) -> list[tuple[int, int]]:
    """[8o]'s bands: the first BAND_ROWS rows, the BAND_ROWS across element
    2^31 of the first plane, and the last BAND_ROWS."""
    mid = (1 << 31) // pitch - BAND_ROWS // 2
    return [(0, BAND_ROWS), (mid, mid + BAND_ROWS), (hp - BAND_ROWS, hp)]


def check_big(model: Model, shape, seed: int = 31) -> dict:
    """[8o] Each of the model's 13 ops on a raw planar of ``shape`` made on
    the card, its plain version on each band of ``band_rows`` with its
    halo, the kernel's rows of the band equal to it (tolerance 0); each
    output freed before the next op."""
    planar = random_planar(shape, model.dtype, seed)
    hp, pitch = shape[1:]
    errs = {}
    for col, fn in model.ops.items():
        got = fn(planar)
        for a, b in band_rows(hp, pitch):
            a0, b0 = max(0, a - BAND_HALO), min(hp, b + BAND_HALO)
            want = model.plain[col](planar[:, a0:b0].contiguous())
            band = got[:, a:b]
            err = max_delta(band, want[:, a - a0:b - a0])
            errs[col] = max(errs.get(col, 0.0), err)
            check(torch.equal(band, want[:, a - a0:b - a0]),
                  f"[8o] {model.dtype} {col} rows {a}-{b} of "
                  f"{tuple(shape)}: kernel differs from its plain version "
                  f"(max |delta| {err})")
        del got, band  # a view of the output keeps it alive
    del planar
    torch.cuda.empty_cache()
    return errs


def drive_big(models, smi) -> dict:
    """[8o] check_big on BIG_SHAPE in both models."""
    t0 = time.perf_counter()
    hp, pitch = BIG_SHAPE[1:]
    out = {}
    for model in models:
        t1 = time.perf_counter()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        errs = check_big(model, BIG_SHAPE)
        item = 4 if model.dtype == "float32" else 1
        out[model.dtype] = {
            "errs": errs, "plane_bytes": hp * pitch * item,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "seconds": time.perf_counter() - t1}
        print(f"  {model.dtype} {BIG_SHAPE}: {hp * pitch:,} elements "
              f"({hp * pitch * item / 1e9:.2f} GB) a plane; 13 ops equal to "
              f"their plain versions on rows {band_rows(hp, pitch)} "
              f"(tolerance 0); peak {out[model.dtype]['peak_gb']:.1f} GB, "
              f"{out[model.dtype]['seconds']:.1f} s")
    seconds = time.perf_counter() - t0
    print(f"  [8o] took {seconds:.1f} s | {smi}")
    return {**out, "seconds": seconds}


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


def serving_table(images, launches: dict) -> tuple[list[dict], list[dict]]:
    """The fused pipeline at each batch size: device time per image of
    one launch on the stack, end-to-end ``process_batch`` time per image
    (the copies into pinned memory and to the card, the layout bake on the
    card, the kernel, the crop on the card, the copy out), the card's bake
    (``bake_u8``, device time; its output held equal to the host's bake,
    slack and halo included) beside the host's NumPy bake of the same
    stack (``stack_planar_padded``, the tests' reference), and the card's crop
    of the pipeline's planar result (``crop_u8``, device time; its output
    held equal to the host's crop) beside its plain version on the card
    and the host's crop of a pinned result to (B, H, W, 3)
    (``from_planar_padded``, which the card's crop replaced in the batch
    tool). Also the ``{"kernels": [...]}`` entries of ``bake_u8`` and
    ``crop_u8`` at the largest batch, beside their plain versions on the
    card and their bounds (the bytes read once and written once at the HBM
    rate); ``launches`` is the batch tool's counts."""
    images = np.stack(images)
    layout = make_layout(*images.shape[1:3])
    rows = []
    for b in SERVING_BATCHES:
        stack = stack_planar_padded(images[:b], layout).cuda()
        dev_ms = timed([fused_pipeline], stack)[0]
        raw = torch.from_numpy(images[:b]).cuda()
        check(torch.equal(bake_stack(raw, layout), stack),
              f"bake_u8 at B={b} differs from stack_planar_padded")
        card_bake, plain_bake = timed([
            lambda s: bake_stack(s, layout),
            lambda s: bake_stack_plain(s, layout)], raw)
        del raw
        result = fused_pipeline(stack)
        check(np.array_equal(crop_stack(result, layout).cpu().numpy(),
                             from_planar_padded(result.cpu(), layout)),
              f"crop_u8 at B={b} differs from from_planar_padded")
        card_crop, plain_crop = timed([
            lambda s: crop_stack(s, layout),
            lambda s: crop_stack_plain(s, layout)], result)
        del result
        batch.process_batch(images[:b])  # warm the pinned-memory cache
        e2e = host_ms(lambda: batch.process_batch(images[:b]))
        bake = host_ms(lambda: stack_planar_padded(images[:b], layout))
        pinned = stack.cpu().pin_memory()
        crop = host_ms(lambda: from_planar_padded(pinned, layout))
        bound_ms, _ = bound("Fused-Pipeline", stack)
        rows.append({"batch": b, "device_us_per_image": 1e3 * dev_ms / b,
                     "bound_us_per_image": 1e3 * bound_ms / b,
                     "e2e_ms_per_image": e2e / b,
                     "bake_ms_per_image": bake / b,
                     "card_bake_ms_per_image": card_bake / b,
                     "crop_ms_per_image": crop / b,
                     "card_crop_ms_per_image": card_crop / b,
                     "plain_crop_ms_per_image": plain_crop / b})
    valid = images[:b].size
    entries = []
    for name, op, ms, plain_ms, moved, tpu in (
            ("bake_u8", "layout bake", card_bake, plain_bake,
             valid + stack.numel(), "to_planar_padded"),
            ("crop_u8", "layout crop", card_crop, plain_crop, 2 * valid,
             "from_planar_padded")):
        bound_ms = 1e3 * moved / HBM_BYTES_S
        entries.append({
            "name": name, "dtype": "uint8", "op": f"{op} B={b}",
            "route": "cuda", "source": CSRC + "layout.cu",
            "replaces": "dip_benchmark_tpu/models/batch.py",
            "tpu_kernel": f"none (the host's {tpu})",
            "launches": launches.get(name, 0), "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None})
        print(f"    {op} B={b:<14d} {name:28s} kernel {ms:9.4f} ms | plain "
              f"{plain_ms:9.4f} ms | library none | bound {bound_ms:.4f} ms "
              f"(bytes)")
    return rows, entries


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
    print("[3h] window_f32_strip bodies (3x3 erosions, convolutions, blur) "
          "at word and strip edges, random masks: kernel against plain "
          "version, tolerance 0")
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
    print("[3l] convolution tile kernels (csrc/conv.cu): every dense shape "
          f"of sides {CONV_SIDES}, separable N {CONV_SEP_NS}, acc_dtype, "
          "int32 wrap, on pad-8 layouts: kernel against plain version, "
          "tolerance 0")
    t0 = time.perf_counter()
    conv_rng = np.random.default_rng(3)
    conv_errs = compare_conv_tiles(conv_rng)
    for name, err in compare_dense_sides(conv_rng).items():
        conv_errs[name] = max(conv_errs.get(name, 0.0), err)
    print(f"  every kh x kw of 1..{window.MAX_CONV_SIDE} on each dense body "
          f"(uint8 int8 weights, uint8 a weight of +-200, float32) on "
          f"{DENSE_SIDES_SHAPE}: equal to the plain version")
    for shape in TWO_PASS_SIDES_SHAPES:
        for name, err in compare_two_pass_sides(conv_rng, shape).items():
            conv_errs[name] = max(conv_errs.get(name, 0.0), err)
    print(f"  every N of 1..{window.MAX_CONV_SIDE} on each two-pass kernel "
          f"(uint8 rounded between, unrounded N x N and N x kw; float32) on "
          f"{TWO_PASS_SIDES_SHAPES}: equal to the plain version")
    conv_counts, conv_ops, drive_errs = drive_conv_tiles(img, sizes[1][1])
    for name, err in drive_errs.items():
        conv_errs[name] = max(conv_errs.get(name, 0.0), err)
    print(f"    full size, device time, median of {TIMED_LAUNCHES} launches "
          f"each, CUDA events, {label} | {smi}")
    conv_entries = time_conv_tiles(img, conv_ops, conv_counts, conv_errs)
    print(f"  [3l] took {time.perf_counter() - t0:.1f} s")
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
    serving, layout_entries = serving_table(variants, batch_counts)
    entries += layout_entries
    for row in serving:
        print(f"    B={row['batch']}: device {row['device_us_per_image']:8.2f}"
              f" us/image (bound {row['bound_us_per_image']:.2f}) | "
              f"process_batch end to end {row['e2e_ms_per_image']:8.2f} "
              f"ms/image (host bake {row['bake_ms_per_image']:.2f}, "
              f"card bake {row['card_bake_ms_per_image']:.4f}, "
              f"host crop {row['crop_ms_per_image']:.2f}, card crop "
              f"{row['card_crop_ms_per_image']:.4f}, plain crop "
              f"{row['plain_crop_ms_per_image']:.4f})")
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
          f"1, 2, models.batch.main --shards 2 --data-shards 2 | {smi}")
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
    wide_run = drive_wide([u8, f32], smi)
    print(f"[8s] row-block streaming: models.wide.apply_streaming on "
          f"{label}, every column of WIDE_COLS in both models")
    streaming = drive_streaming([u8, f32], img, label, smi)
    print("[8t] tall images: every launcher past its old gridDim.y cap, "
          "the CLI and apply_streaming")
    tall = drive_tall([u8, f32], smi)
    print("[8o] planes past 2^31 elements: the 13 ops of each model against "
          "their plain versions on bands")
    big = drive_big([u8, f32], smi)

    entries += conv_entries
    want = (28 + len(DENSE_MASKS) + 2 * len(CHAINS) + len(MORPHOLOGY)
            + len(CONV_TIMED))
    check(len(entries) == want, f"{len(entries)} kernel entries, want {want}")
    summary = {"kernels": entries}
    with open(os.path.join(OUT, "summary.json"), "w") as f:
        json.dump({**summary, "serving": serving, "batch_tool_launches":
                   batch_counts, "chain_batch_tool_launches":
                   chain_batch_counts, "op_batch_tool_launches":
                   op_batch_counts, "morphology_launches": morph_counts,
                   "conv_tile_launches": conv_counts,
                   "main_path_launches": counts, "library_exec": library_exec,
                   "exec": exec_runs, "chained": chained,
                   "host_share": host_split, "sharded": sharded,
                   "native_oracle": native_oracle, "wide": wide_run,
                   "streaming": streaming, "tall": tall, "big": big,
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
