"""Fused op chains of the port (models/chain.py, K17 and K18) against the
JAX package's chains and the port's sequential oracles.

The JAX chains run as tests/test_chain.py runs them (Pallas interpret mode
on the CPU) on a JAX planar baked with the chain's halo; the port gets the
identical buffer through ``from_jax_planar(..., pad=R)`` and, on CPU
tensors, runs the plain chain. The JAX kernels leave the outer columns as
lane-roll garbage, so the two are compared on the crop. uint8 is
bit-exact by spec; float32 agrees within ``atol=3e-7``, as in
tests/test_torch_f32.py (the interpret run may contract a multiply-add
into an FMA), outside the don't-care mask where a Threshold follows a
computed value. The port's own oracle checks are cheap (no JAX) and cover
seeded random chains; the card-only tests at the end hold the CUDA kernels
against the plain versions at tolerance 0 (chain_u8 also at edge shapes and
on random stage lists) and skip without a card.
"""

import os
import re

import jax
import numpy as np
import pytest
import torch

from dip_benchmark_tpu import session as jax_session
from dip_benchmark_tpu.models import chain as jax_chain
from dip_benchmark_tpu.utils import image as jax_image
from dip_benchmark_tpu_torch import cli, oracle, spec
from dip_benchmark_tpu_torch.models import batch, chain
from dip_benchmark_tpu_torch.ops import PLAIN, PLAIN_F32, kernels, window
from dip_benchmark_tpu_torch.ops.kernels.build import CSRC
from dip_benchmark_tpu_torch.session import BenchmarkSession
from dip_benchmark_tpu_torch.utils.image import (from_jax_planar,
                                                 from_planar_padded,
                                                 from_planar_padded_f32,
                                                 load_image, make_layout,
                                                 save_image,
                                                 to_planar_padded,
                                                 to_planar_padded_f32)

ATOL_F32 = 3e-7  # tests/test_torch_f32.py
POOL = ["Copy", "Inversion", "Threshold", "Erosion-3x3-Cross",
        "Erosion-3x3-Square", "Erosion-1x3+3x1-Square", "Convolution-3x3",
        "Convolution-1x3+3x1", "Convolution-5x5", "Convolution-1x5+5x1",
        "Gaussian-Blur-3x3"]
# tests/test_chain.py's CHAINS (uint8) and its float32 list, each with the
# halo its JAX bake needs (at least 2).
CHAINS_U8 = [
    (["Grayscale", "Threshold", "Erosion-3x3-Square", "Gaussian-Blur-3x3"],
     2),
    (["Inversion", "Convolution-3x3"], 2),
    (["Convolution-1x5+5x1", "Erosion-3x3-Cross"], 3),
    (["Convolution-5x5", "Convolution-3x3", "Erosion-3x3-Square",
      "Threshold"], 4),
    (["Erosion-1x3+3x1-Square", "Copy"], 2),
    (["Grayscale", "Convolution-1x3+3x1"], 2),
]
CHAINS_F32 = [
    (["Grayscale", "Threshold", "Erosion-3x3-Square", "Gaussian-Blur-3x3"],
     2),
    (["Inversion", "Convolution-5x5"], 2),
    (["Convolution-1x3+3x1", "Erosion-3x3-Cross"], 2),
    (["Convolution-5x5", "Convolution-1x5+5x1"], 4),
]
# The four chains chip_smoke.py drives on the card.
C1 = ["Convolution-5x5", "Inversion", "Convolution-3x3"]
C2 = ["Grayscale", "Threshold", "Erosion-3x3-Square", "Gaussian-Blur-3x3"]
C3 = ["Convolution-1x5+5x1", "Erosion-3x3-Cross"]
C4 = ["Convolution-5x5"] * 4


def ids(case):
    return "+".join(case) if isinstance(case, list) else str(case)


def random_image(hw, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, hw + (3,), np.uint8)


def random_chains(rng, n: int) -> list[list[str]]:
    """``n`` random chains of 1 to 5 ops, half of them Grayscale first,
    within the radius bound, as test_chain_fuzz_random_sequences draws."""
    chains = []
    while len(chains) < n:
        cols = [POOL[int(i)] for i in rng.integers(0, len(POOL),
                                                    int(rng.integers(1, 6)))]
        if rng.integers(0, 2):
            cols = ["Grayscale"] + cols
        if max(chain.chain_radius(cols)) <= chain.MAX_CHAIN_RADIUS:
            chains.append(cols)
    return chains


def port_chain(image: np.ndarray, cols, dtype: str) -> np.ndarray:
    """The port's plain chain on a bake with the chain's halo, cropped to
    uint8 HWC."""
    layout = make_layout(*image.shape[:2], pad=max(2, *chain.check_chain(
        cols)))
    if dtype == "float32":
        out = chain.make_fused_chain_f32(layout, cols)(
            to_planar_padded_f32(image, layout))
        return from_planar_padded_f32(out, layout)
    out = chain.make_fused_chain(layout, cols)(to_planar_padded(image,
                                                               layout))
    return from_planar_padded(out, layout)


def assert_within_oracle(got: np.ndarray, expected, atol: int, what=""):
    dontcare = None
    if isinstance(expected, tuple):
        expected, dontcare = expected
    delta = np.abs(got.astype(int) - expected.astype(int))
    if dontcare is not None:
        delta[dontcare] = 0
    assert delta.max(initial=0) <= atol, what


# -- the port against the JAX package --------------------------------------

@pytest.mark.parametrize("cols,halo", CHAINS_U8, ids=ids)
def test_uint8_chain_matches_jax_chain(cols, halo, small_image):
    jax_layout = jax_image.make_layout(*small_image.shape[:2], halo=halo)
    jax_planar = jax_image.to_planar_padded(small_image, jax_layout)
    want = jax_image.from_planar_padded(np.asarray(jax_chain.make_fused_chain(
        jax_layout, cols)(jax.device_put(jax_planar))), jax_layout)
    layout = make_layout(*small_image.shape[:2], pad=halo)
    got = chain.make_fused_chain(layout, cols)(
        from_jax_planar(jax_planar, jax_layout, pad=halo))
    np.testing.assert_array_equal(from_planar_padded(got, layout), want)


def f32_crop(arr, layout_h, layout_w, py, px) -> np.ndarray:
    return np.asarray(arr)[..., py:py + layout_h, px:px + layout_w]


def dontcare_chw(image: np.ndarray, cols) -> np.ndarray | None:
    """The f32 sequential oracle's don't-care mask as (H, W), or None."""
    expected = chain.chain_row_parts(cols, "float32")[2](image)
    return expected[1][..., 0] if isinstance(expected, tuple) else None


@pytest.mark.parametrize("cols,halo", CHAINS_F32, ids=ids)
def test_float32_chain_matches_jax_chain(cols, halo, small_image):
    h, w, _ = small_image.shape
    jax_layout = jax_image.make_layout(h, w, halo=halo)
    jax_planar = jax_image.to_planar_padded_f32(small_image, jax_layout)
    want = f32_crop(jax_chain.make_fused_chain_f32(jax_layout, cols)(
        jax.device_put(jax_planar)), h, w, halo, halo)
    layout = make_layout(h, w, pad=halo)
    out = chain.make_fused_chain_f32(layout, cols)(
        from_jax_planar(jax_planar, jax_layout, pad=halo))
    got = f32_crop(out.numpy(), h, w, halo, halo)
    delta = np.abs(got - want)
    mask = dontcare_chw(small_image, cols)
    if mask is not None:
        delta[:, mask] = 0
    assert delta.max() <= ATOL_F32


@pytest.mark.parametrize("cols,dtype", [(C3, "uint8"), (C2, "uint8"),
                                        (C2, "float32")], ids=ids)
def test_batched_chain_matches_jax_batched_chain(cols, dtype):
    h, w = 24, 40
    images = np.stack([random_image((h, w), seed=s) for s in (5, 6, 7)])
    halo = max(2, *chain.check_chain(cols))
    jax_layout = jax_image.make_layout(h, w, halo=halo)
    layout = make_layout(h, w, pad=halo)
    f32 = dtype == "float32"
    bake = (jax_image.to_planar_padded_f32 if f32
            else jax_image.to_planar_padded)
    jax_stack = np.stack([bake(im, jax_layout) for im in images])
    make = (jax_chain.make_fused_chain_f32 if f32
            else jax_chain.make_fused_chain)
    want = np.asarray(make(jax_layout, cols, batch=3)(
        jax.device_put(jax_stack)))
    port = chain.make_fused_chain_f32 if f32 else chain.make_fused_chain
    got = port(layout, cols, batch=3)(
        from_jax_planar(jax_stack, jax_layout, pad=halo)).numpy()
    for b in range(3):
        g = f32_crop(got[b], h, w, halo, halo)
        j = f32_crop(want[b], h, w, halo, halo)
        if f32:
            delta = np.abs(g - j)
            mask = dontcare_chw(images[b], cols)
            if mask is not None:
                delta[:, mask] = 0
            assert delta.max() <= ATOL_F32, b
        else:
            np.testing.assert_array_equal(g, j, err_msg=f"image {b}")


def test_radius_8_chain_matches_jax_chain(small_image):
    jax_layout = jax_image.make_layout(*small_image.shape[:2], halo=8)
    jax_planar = jax_image.to_planar_padded(small_image, jax_layout)
    want = jax_image.from_planar_padded(np.asarray(jax_chain.make_fused_chain(
        jax_layout, C4)(jax.device_put(jax_planar))), jax_layout)
    layout = make_layout(*small_image.shape[:2], pad=8)
    got = chain.make_fused_chain(layout, C4)(
        from_jax_planar(jax_planar, jax_layout, pad=8))
    np.testing.assert_array_equal(from_planar_padded(got, layout), want)


def test_chain_algebra_matches_the_jax_package():
    rng = np.random.default_rng(41)
    for cols in random_chains(rng, 40):
        assert chain.chain_radius(cols) == jax_chain.chain_radius(cols), cols
        for dtype in ("uint8", "float32"):
            port = chain.chain_row_parts(cols, dtype)
            ref = jax_chain.chain_row_parts(cols, dtype)
            assert port[:2] == ref[:2]


# -- the port against its oracle, and its whole-buffer contract ------------

@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_random_chains_match_the_sequential_oracle(dtype):
    rng = np.random.default_rng(7 if dtype == "uint8" else 8)
    image = rng.integers(0, 256, (21, 33, 3), np.uint8)
    atol = 1 if dtype == "float32" else 0
    for cols in random_chains(rng, 30):
        expected = chain.chain_row_parts(cols, dtype)[2](image)
        assert_within_oracle(port_chain(image, cols, dtype), expected, atol,
                             cols)


def sequential_plain(planar: torch.Tensor, cols, plain: dict):
    for c in cols:
        planar = plain[c](planar)
    return planar


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_plain_chain_is_the_sequential_plain_ops_inside_a_zero_ring(dtype):
    # The float32 op #14 rounds in another order than the chain's dense
    # 3x3 stage, so its sequential form is left out there.
    rng = np.random.default_rng(9)
    image = random_image((30, 41), seed=9)
    f32 = dtype == "float32"
    plain = PLAIN_F32 if f32 else PLAIN
    tested = 0
    for cols in random_chains(rng, 20):
        if f32 and "Gaussian-Blur-3x3" in cols:
            continue
        ry, rx = chain.check_chain(cols)
        layout = make_layout(30, 41, pad=max(2, ry, rx))
        planar = (to_planar_padded_f32 if f32 else to_planar_padded)(
            image, layout)
        want = window.zero_ring(sequential_plain(planar, cols, plain).clone(),
                                ry, rx)
        got = chain.fused_chain_plain(planar, cols, dtype)
        assert torch.equal(got, want), cols
        tested += 1
    assert tested >= 10


def test_plain_chain_zero_ring_only(gradient_image):
    # A bright image through a chain whose every value is > 0 inside: the
    # zeros are exactly the (Ry, Rx) ring.
    cols = ["Convolution-1x5+5x1", "Convolution-3x3"]  # ry = rx = 3
    layout = make_layout(*gradient_image.shape[:2], pad=3)
    out = chain.fused_chain_plain(
        to_planar_padded(gradient_image // 2 + 100, layout), cols)
    inside = torch.zeros_like(out, dtype=torch.bool)
    inside[:, 3:-3, 3:-3] = True
    assert bool((out[inside] > 0).all()) and bool((out[~inside] == 0).all())


def test_point_chain_has_no_ring(small_image):
    layout = make_layout(*small_image.shape[:2])
    planar = to_planar_padded(small_image, layout)
    out = chain.make_fused_chain(layout, ["Inversion", "Threshold"])(planar)
    assert chain.chain_radius(["Inversion", "Threshold"]) == (0, 0)
    assert torch.equal(out, PLAIN["Threshold"](PLAIN["Inversion"](planar)))


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_grayscale_alone_is_a_chain(dtype, small_image):
    # No stage after the luma: an empty descriptor, radius 0.
    assert chain.check_chain(["Grayscale"]) == (0, 0)
    assert chain._encode(chain._chain_stages(["Grayscale"])[1],
                         dtype == "float32").size == 0
    expected = chain.chain_row_parts(["Grayscale"], dtype)[2](small_image)
    assert_within_oracle(port_chain(small_image, ["Grayscale"], dtype),
                         expected, 0)


def test_float32_blur_stage_is_the_dense_convolution(fundus_crop):
    # The trap: the chain's Gaussian-Blur-3x3 is _conv_rank1_f32 with the
    # 3x3 mask, not the standalone blur's 0.25 / 0.5 order.
    layout = make_layout(*fundus_crop.shape[:2])
    planar = to_planar_padded_f32(fundus_crop, layout)
    got = chain.fused_chain_plain(planar, ["Gaussian-Blur-3x3"], "float32")
    assert torch.equal(got, PLAIN_F32["Convolution-3x3"](planar))


def test_stages_follow_the_jax_stage_forms():
    gray, stages = chain._chain_stages(
        ["Grayscale", "Erosion-1x3+3x1-Square", "Gaussian-Blur-3x3",
         "Convolution-1x5+5x1", "Threshold"])
    assert gray
    assert [(s.kind, s.mask.shape, s.shift) for s in stages] == [
        ("min", (3, 3), 0), ("conv", (3, 3), spec.BLUR_3X3_SHIFT),
        ("conv", (1, 5), spec.BLUR_SEP5_SHIFT),
        ("conv", (5, 1), spec.BLUR_SEP5_SHIFT), ("threshold", (1, 1), 0)]
    np.testing.assert_array_equal(stages[0].mask, spec.SQUARE_MASK_3X3)
    np.testing.assert_array_equal(stages[1].mask, spec.BLUR_3X3_INT)


def test_descriptor_encoding():
    _, stages = chain._chain_stages(["Inversion", "Convolution-1x3+3x1"])
    w = [int(v) for v in np.ravel(spec.BLUR_1X3_INT)]
    s = spec.BLUR_SEP3_SHIFT
    # uint8: a conv stage carries its rank-1 factors u (kh), then v (kw).
    assert chain._encode(stages, False).tolist() == [
        1, 1, 1, 0, 0, 4, 1, 3, s, 1, *w, 4, 3, 1, s, *w, 1]
    # float32: its kh * kw weights int / 2**shift, as float bits.
    words = chain._encode(stages, True)
    assert words.size == 5 + 2 * (4 + 3)
    floats = words[5 + 4:5 + 4 + 3].view(np.float32)
    np.testing.assert_array_equal(
        floats, np.ravel(spec.mask_float(spec.BLUR_1X3_INT, s)))


def conv_columns():
    return [c for c in POOL if c.startswith(("Convolution", "Gaussian"))]


@pytest.mark.parametrize("col", conv_columns())
def test_uint8_conv_stages_carry_factors_of_their_mask(col):
    # Each factor pair multiplies back to the stage's integer mask exactly,
    # within the packed-16 bound that chain.cu checks on the host copy.
    _, stages = chain._chain_stages([col])
    words = chain._encode(stages, False).tolist()
    i = 0
    for stage in stages:
        kind, kh, kw, shift = words[i:i + 4]
        assert (kind, kh, kw, shift) == (chain.KINDS["conv"],
                                         *stage.mask.shape, stage.shift)
        u = np.array(words[i + 4:i + 4 + kh])
        v = np.array(words[i + 4 + kh:i + 4 + kh + kw])
        np.testing.assert_array_equal(np.outer(u, v), stage.mask)
        assert (u >= 0).all() and (v >= 0).all()
        assert 255 * u.sum() * v.sum() + ((1 << shift) >> 1) < 1 << 16
        i += 4 + kh + kw
    assert i == len(words)


@pytest.mark.parametrize("mask,shift", [
    (np.array([[1, 2, 1], [2, 1, 2], [1, 2, 1]]), 4),
    (np.outer([1, 2, 1], [-1, 4, -1]), 2),
    (np.outer([1, 4, 6, 4, 1], [2, 4, 6, 4, 1]), 8),
    (spec.BLUR_3X3_INT, 16),
], ids=["rank-2", "negative", "fields-carry", "shift-16"])
def test_uint8_descriptor_refuses_a_mask_without_factors(mask, shift):
    stage = chain.Stage("conv", mask.astype(np.int32), shift)
    with pytest.raises(ValueError, match="rank-1 integer factors"):
        chain._encode([stage], False)
    # The float32 chain takes any mask as its weights.
    assert chain._encode([stage], True).size == 4 + mask.size


def test_float32_point_runs_fold_exactly():
    # chain_f32 folds a run of point stages (RunF32) into inv inversions
    # applied one by one, then the threshold xor the parity of the
    # inversions after it: the same floats as the stages one after another,
    # since after a threshold every value is 0 or 1.
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.random(4000, dtype=np.float32),
                        rng.normal(0.5, 3, 4000).astype(np.float32),
                        np.float32(0.5) + np.float32(2.0) ** -np.arange(
                            1, 30, dtype=np.float32),
                        np.array([0, 0.5, 1, -0.0], np.float32)])
    one = np.float32(1)
    for _ in range(300):
        run = rng.choice(["copy", "invert", "threshold"],
                         int(rng.integers(1, 7)))
        want = x.copy()
        for kind in run:
            if kind == "invert":
                want = one - want
            elif kind == "threshold":
                want = (want > 0.5).astype(np.float32)
        inv, threshold, flip = 0, False, False
        for kind in run:
            if kind == "invert":
                if threshold:
                    flip = not flip
                else:
                    inv += 1
            elif kind == "threshold":
                threshold = True
        got = x.copy()
        for _ in range(inv):
            got = one - got
        if threshold:
            got = ((got > 0.5) != flip).astype(np.float32)
        np.testing.assert_array_equal(got, want, err_msg=str(run))


def test_kernel_constants_equal_the_port():
    # chain.cu compiles these numbers in; hold each line to its source.
    with open(os.path.join(CSRC, "chain.cu")) as f:
        src = f.read()
    consts = {m[0]: int(m[1])
              for m in re.findall(r"constexpr int (k\w+) = (-?\d+);", src)}
    assert consts["kThresholdU8"] == spec.THRESHOLD_VALUE
    assert consts["kThresholdMaxU8"] == spec.THRESHOLD_MAX
    assert consts["kMaxRadius"] == chain.MAX_CHAIN_RADIUS
    assert {k: consts["k" + k.capitalize()] for k in chain.KINDS} == \
        chain.KINDS
    # A point stage is the header and one word; chain_u8's halo words
    # cover the deepest chain.
    assert chain._encode([chain.Stage("copy")], False).size == \
        consts["kHeader"] + 1
    assert 4 * consts["kHaloWords"] >= chain.MAX_CHAIN_RADIUS


# -- refusals: the same text in both packages ------------------------------

@pytest.mark.parametrize("cols,says", [
    (["Convolution-5x5"] * 5, "chain radius"),
    (["Inversion", "Grayscale"], "Grayscale may appear only as the first"),
    (["Upload"], "op not fusable in a chain"),
    ([], "empty chain"),
], ids=["radius-10", "grayscale-not-first", "upload", "empty"])
def test_refusals_match_the_jax_package(cols, says):
    jax_layout = jax_image.make_layout(16, 16)
    with pytest.raises(ValueError, match=says):
        jax_chain.make_fused_chain(jax_layout, cols)
    with pytest.raises(ValueError, match=says):
        jax_chain.check_chain(cols)
    with pytest.raises(ValueError, match=says):
        chain.make_fused_chain(make_layout(16, 16), cols)
    with pytest.raises(ValueError, match=says):
        chain.check_chain(cols)


def test_chain_wider_than_the_layout_halo_is_refused():
    jax_layout = jax_image.make_layout(16, 16)
    with pytest.raises(ValueError, match="exceeds the layout halo"):
        jax_chain.make_fused_chain(jax_layout, C1)
    with pytest.raises(ValueError, match="exceeds the layout halo"):
        chain.make_fused_chain_f32(make_layout(16, 16), C1)


def test_session_refuses_an_image_too_small_for_the_chain():
    image = random_image((6, 7), seed=3)
    says = "too small for a radius-8 fused chain"
    with pytest.raises(ValueError, match=says):
        jax_session.BenchmarkSession(image, path="pallas").chain_operation(C4)
    with pytest.raises(ValueError, match=says):
        BenchmarkSession(image, "cpu").chain_operation(C4)


def test_wrapper_checks_its_input(small_image):
    layout = make_layout(*small_image.shape[:2])
    fn = chain.make_fused_chain(layout, C2)
    planar = to_planar_padded(small_image, layout)
    with pytest.raises(ValueError, match="built for"):
        fn(torch.stack([planar, planar]))
    with pytest.raises(ValueError):
        fn(planar.to(torch.float32))
    with pytest.raises(ValueError, match="meta"):
        fn(torch.empty(planar.shape, dtype=torch.uint8, device="meta"))


def test_cpu_chain_launches_no_kernel(small_image):
    layout = make_layout(*small_image.shape[:2], pad=3)
    kernels.reset_launches()
    chain.make_fused_chain(layout, C1)(to_planar_padded(small_image, layout))
    chain.make_fused_chain_f32(layout, C2)(
        to_planar_padded_f32(small_image, layout))
    assert kernels.LAUNCHES == {}


# -- entry points on the CPU -----------------------------------------------

def table_rows(text: str) -> list[str]:
    return [ln for ln in text.splitlines() if ln.startswith("| ")]


@pytest.mark.parametrize("dtype,cols,pipeline", [
    ("uint8", C1, True), ("uint8", C3, False), ("float32", C2, True),
    ("float32", C1, False)], ids=ids)
def test_cli_fuse_row(dtype, cols, pipeline, tmp_path, small_image, capsys):
    img = str(tmp_path / "small.png")
    save_image(img, small_image)
    csv = str(tmp_path / "r.csv")
    argv = [img, str(tmp_path / "out"), "--rounds", "1", "--backend", "cpu",
            "--dtype", dtype, "--verify", "--warmup", "0", "--fuse",
            ",".join(cols), "--csv", csv] + (["--pipeline"] if pipeline
                                             else [])
    assert cli.main(argv) == 0
    rows = table_rows(capsys.readouterr().out)
    assert len(rows) == (16 if pipeline else 15)
    assert rows[-1].split("|")[1].strip() == chain.chain_row_parts(cols)[0]
    dumps = os.listdir(tmp_path / "out")
    assert "chain-small.png" in dumps and len(dumps) == 13 + pipeline
    expected = chain.chain_row_parts(cols, dtype)[2](small_image)
    assert_within_oracle(load_image(str(tmp_path / "out" / "chain-small.png")),
                         expected, 1 if dtype == "float32" else 0)
    with open(csv) as f:
        lines = f.read().splitlines()
    assert lines[0] == spec.CSV_HEADER
    assert len(lines[1].split(",")) == len(spec.CSV_COLUMNS) + 1


@pytest.mark.parametrize("fuse", ["Inversion,Grayscale", "Upload",
                                  "Convolution-5x5," * 5 + "Copy"])
def test_cli_refuses_a_bad_chain(fuse, tmp_path, small_image, capsys):
    img = str(tmp_path / "small.png")
    save_image(img, small_image)
    assert cli.main([img, str(tmp_path / "out"), "--rounds", "1",
                     "--backend", "cpu", "--fuse", fuse]) == 2
    assert "--fuse: " in capsys.readouterr().err


def test_session_chain_operation_bakes_a_deeper_halo(small_image):
    session = BenchmarkSession(small_image, "cpu")
    op = session.chain_operation(C3)  # radius 3 > the session's halo 2
    op.run()
    assert tuple(session._sample.shape) == make_layout(
        *small_image.shape[:2], pad=3).shape
    assert op.prefix == "chain"
    np.testing.assert_array_equal(
        op.fetch(), session.oracle_ops()[op.csv_column](small_image))
    assert op.csv_column == chain.chain_row_parts(C3)[1]


def test_batch_tool_runs_a_chain(tmp_path):
    images = {f"im{i}.png": random_image((20, 28), seed=i) for i in range(3)}
    images["odd.png"] = random_image((12, 9), seed=9)
    (tmp_path / "in").mkdir()
    for name, im in images.items():
        save_image(str(tmp_path / "in" / name), im)
    assert batch.main([str(tmp_path / "in"), str(tmp_path / "out"), "--op",
                       ",".join(C3), "--batch-size", "2", "--backend",
                       "cpu"]) == 0
    seq = chain.chain_row_parts(C3)[2]
    for name, im in images.items():
        np.testing.assert_array_equal(
            load_image(str(tmp_path / "out" / name)), seq(im))


def test_process_batch_takes_a_list_of_columns():
    images = np.stack([random_image((16, 24), seed=s) for s in (1, 2)])
    got = batch.process_batch(images, C2, device="cpu")
    for b in range(2):
        np.testing.assert_array_equal(got[b], oracle.fused_pipeline(
            images[b]))


# -- on the card -----------------------------------------------------------

def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("cols", [C1, C2, C3, C4, ["Grayscale"]], ids=ids)
def test_kernel_matches_plain_on_card(cols, dtype):
    card()
    f32 = dtype == "float32"
    make = chain.make_fused_chain_f32 if f32 else chain.make_fused_chain
    bake = to_planar_padded_f32 if f32 else to_planar_padded
    images = np.stack([random_image((37, 53), seed=s) for s in (1, 2, 3)])
    layout = make_layout(37, 53, pad=max(2, *chain.check_chain(cols)))
    planar = bake(images[0], layout).cuda()
    got = make(layout, cols)(planar)
    torch.cuda.synchronize()
    assert got.is_cuda
    assert torch.equal(got, chain.fused_chain_plain(planar, cols, dtype))
    stack = torch.stack([bake(im, layout) for im in images]).cuda()
    kernels.reset_launches()
    got = make(layout, cols, batch=3)(stack)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {make(layout, cols).kernel: 1}
    assert torch.equal(got, chain.fused_chain_plain(stack, cols, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["C1", "C2", "C3", "C4", "G"])
def test_kernel_matches_plain_on_card_at_edges(name):
    # chip_smoke.py phase 3g: the smallest image the chain takes, rows that
    # end short of a tile, 2341x3501 and raw buffers, one image and B=2.
    card()
    import chip_smoke
    cols = chip_smoke.CHECKED_CHAINS[name]
    rng = np.random.default_rng(len(cols))
    for label, planar in chip_smoke.chain_edge_inputs(rng, cols):
        shape = tuple(planar.shape)
        planar = planar.cuda()
        stack = torch.stack([planar, planar.flip(-1).contiguous()])
        for p, b in ((planar, 0), (stack, 2)):
            got = chip_smoke.raw_chain(shape, cols, b)(p)
            torch.cuda.synchronize()
            assert torch.equal(got, chain.fused_chain_plain(p, cols)), (
                f"{name} on {label}, batch {b}")


@pytest.mark.cuda
def test_random_stage_lists_match_plain_on_card():
    # chip_smoke.py phase 3g: rank-1 masks that clamp, shifts above 8,
    # separated pairs, min and point stages, on raw buffers.
    card()
    import chip_smoke
    rng = np.random.default_rng(11)
    for shape in chip_smoke.CHAIN_EDGE_BUFFERS:
        planar = torch.from_numpy(rng.integers(0, 256, shape,
                                               np.uint8)).cuda()
        for stages in chip_smoke.random_chain_stages(rng, 12):
            got = chip_smoke.chain_stages(stages, planar)
            torch.cuda.synchronize()
            assert torch.equal(got, chip_smoke.stages_plain(stages, planar))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["C1", "C2", "C3", "C4", "G"])
def test_float32_kernel_matches_plain_on_card_at_edges(name):
    # chip_smoke.py phase 3i: chain_f32 at chain_u8's edge shapes, as
    # float32 planars, one image and B=2.
    card()
    import chip_smoke
    cols = chip_smoke.CHECKED_CHAINS[name]
    rng = np.random.default_rng(100 + len(cols))
    for label, planar in chip_smoke.chain_edge_inputs(rng, cols):
        shape = tuple(planar.shape)
        planar = (torch.from_numpy(rng.random(shape, dtype=np.float32))
                  if label.startswith("raw") else planar.float() / 255)
        planar = planar.cuda()
        stack = torch.stack([planar, planar.flip(-1).contiguous()])
        for p, b in ((planar, 0), (stack, 2)):
            got = chip_smoke.raw_chain(shape, cols, b, "float32")(p)
            torch.cuda.synchronize()
            assert torch.equal(got, chain.fused_chain_plain(
                p, cols, "float32")), f"{name} on {label}, batch {b}"


@pytest.mark.cuda
def test_random_float32_stage_lists_match_plain_on_card():
    # chip_smoke.py phase 3i: masks of 10-bit ints of either sign over
    # 2^10, separated pairs, min and point stages, on raw buffers.
    card()
    import chip_smoke
    rng = np.random.default_rng(13)
    for shape in chip_smoke.CHAIN_EDGE_BUFFERS:
        planar = torch.from_numpy(rng.random(shape, dtype=np.float32)).cuda()
        for stages in chip_smoke.random_chain_stages(rng, 12, float32=True):
            got = chip_smoke.chain_stages(stages, planar)
            torch.cuda.synchronize()
            assert torch.equal(got, chip_smoke.stages_plain(stages, planar))


@pytest.mark.cuda
def test_batch_tool_chain_on_card():
    card()
    images = np.stack([random_image((37, 53), seed=s) for s in (4, 5, 6)])
    kernels.reset_launches()
    got = batch.process_batch(images, C3)
    assert kernels.LAUNCHES == {"bake_u8": 1, "chain_u8": 1, "crop_u8": 1}
    seq = chain.chain_row_parts(C3)[2]
    for b in range(3):
        np.testing.assert_array_equal(got[b], seq(images[b]))

