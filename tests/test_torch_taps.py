"""The generic structuring element's decomposition (``window.tap_runs``) and
program (``window.taps_program``), which the Taps kernels run.

On the CPU no kernel runs, so the tests hold the host side to the element:
- the descriptor's runs and builds cover exactly the element's taps, and
  each build uses only tables built before it;
- a PyTorch evaluation of the descriptor, runs then rows, equals
  ``morphology_plain`` and the JAX package's ``make_erosion`` /
  ``make_dilation`` and float32 ``_make_erosion`` (Pallas interpret mode)
  at tolerance 0 on the crop;
- ``emulate_program`` runs the program as the kernels do, tile by tile on
  a frame of ``TAPS_FRAME`` positions, with every value the kernel could
  read but must not use (columns past the frame, rows a table was not
  built on, stale slots) set to NaN, and must equal ``morphology_plain``
  with no NaN in the output.
Min and max are exact in any order, so every comparison is at tolerance 0.
The card-only test at the end holds the kernels to the plain version.
"""

import os
import re

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dip_benchmark_tpu.ops.pallas import f32 as jax_f32
from dip_benchmark_tpu.ops.pallas import window as jax_window
from dip_benchmark_tpu.utils import image as jax_image
from dip_benchmark_tpu_torch.ops import f32, kernels, window
from dip_benchmark_tpu_torch.ops.kernels import build
from dip_benchmark_tpu_torch.utils.image import (from_jax_planar, make_layout,
                                                 to_planar_padded,
                                                 to_planar_padded_f32)


def disc(radius: int) -> np.ndarray:
    d = np.arange(-radius, radius + 1)
    return d[:, None] ** 2 + d[None, :] ** 2 <= radius ** 2


def random_element(seed: int) -> tuple:
    """Seeded random taps of radius 0..8: dense or sparse, centred or
    off-centre, with empty inner rows and rows of several runs."""
    rng = np.random.default_rng(seed)
    r = int(rng.integers(0, 9))
    mask = rng.random((2 * r + 1, 2 * r + 1)) < rng.choice([0.15, 0.5, 0.9])
    if r and rng.random() < 0.5:
        mask[rng.integers(0, 2 * r + 1)] = False       # an empty row
    if r and rng.random() < 0.3:
        mask[:, : rng.integers(1, r + 1)] = False      # off-centre
    if not mask.any():
        mask[rng.integers(0, 2 * r + 1), rng.integers(0, 2 * r + 1)] = True
    return window.mask_to_taps(mask)


RING_5X5 = np.ones((5, 5), bool)
RING_5X5[1:4, 1:4] = False
CHECKER_17 = (np.add.outer(np.arange(17), np.arange(17)) % 2 == 0)
STAIRS_17 = np.tril(np.ones((17, 17), bool))   # every run length 1..17
NAMED = {
    "diamond-5x5": np.add.outer(np.abs(np.arange(-2, 3)),
                                np.abs(np.arange(-2, 3))) <= 2,
    "square-5x5": np.ones((5, 5), bool),
    "row-1x5": np.ones((1, 5), bool),
    "column-5x1": np.ones((5, 1), bool),
    "ring-5x5": RING_5X5,
    "disc-9x9": disc(4),
    "square-17x17": np.ones((17, 17), bool),
    "checker-17x17": CHECKER_17,
    "stairs-17x17": STAIRS_17,
}
SINGLE = {"single-centre": ((0, 0),), "single-off-centre": ((3, -2),),
          "single-corner": ((-2, 1),), "pair-far": ((-8, 8), (8, -8))}


def named_taps(name: str) -> tuple:
    return SINGLE.get(name) or window.mask_to_taps(NAMED[name])


ALL_NAMES = sorted(NAMED) + sorted(SINGLE)
SEEDS = list(range(24))


# -- the descriptor ---------------------------------------------------------

def build_taps(runs, length: int) -> set:
    """The offsets ``H_length[p]`` reduces, relative to p, expanded
    through the builds: ``range(length)`` for a sound build."""
    if length == 1:
        return {0}
    terms = dict(runs.builds)[length]
    return {s + k for a, s in terms for k in build_taps(runs, a)}


def check_runs(taps, tables=None) -> None:
    runs = window.tap_runs(taps, tables)
    assert runs.taps() == set(taps)
    # The runs are the maximal runs of each row, and cover it.
    for dy, row in enumerate(runs.runs):
        dxs = {dx for d, dx in taps if d == dy - runs.hy}
        assert {dx for lo, hi in row for dx in range(lo, hi + 1)} == dxs
        assert all(b[0] > a[1] + 1 for a, b in zip(row, row[1:]))
    built = {1}
    for length, terms in runs.builds:
        assert all(a in built and a < length for a, _ in terms)
        assert build_taps(runs, length) == set(range(length))
        built.add(length)
    assert {a for row in runs.rows for a, _ in row} <= built


@pytest.mark.parametrize("tables", [None, "pow2", (3,), ()])
@pytest.mark.parametrize("name", ALL_NAMES)
def test_runs_cover_the_named_elements(name, tables):
    check_runs(named_taps(name), tables)


@pytest.mark.parametrize("seed", SEEDS)
def test_runs_cover_random_elements(seed):
    taps = random_element(seed)
    rng = np.random.default_rng(seed)
    check_runs(taps)
    check_runs(taps, "pow2")
    check_runs(taps, tuple(int(a) for a in rng.choice(
        np.arange(2, 18), int(rng.integers(0, 5)), replace=False)))


@settings(max_examples=60, deadline=None, database=None)
@given(st.sets(st.tuples(st.integers(-8, 8), st.integers(-8, 8)),
               min_size=1, max_size=60),
       st.sets(st.integers(2, 17), max_size=4))
def test_runs_cover_any_element(taps, tables):
    check_runs(tuple(sorted(taps)))
    check_runs(tuple(sorted(taps)), "pow2")
    check_runs(tuple(sorted(taps)), tuple(sorted(tables)))


def test_diamond_needs_runs_of_one_three_and_five():
    runs = window.tap_runs(named_taps("diamond-5x5"))
    assert [length for length, _ in runs.builds] == [3, 5]
    assert runs.rows == (((1, 0),), ((3, -1),), ((5, -2),), ((3, -1),),
                         ((1, 0),))
    square = window.tap_runs(named_taps("square-17x17"))
    assert [length for length, _ in square.builds] == [3, 5, 9, 17]
    assert all(row == ((17, -8),) for row in square.rows)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("name", ALL_NAMES)
def test_program_fits_the_kernels(name, dtype):
    prog = window.taps_program(named_taps(name),
                               window.TAPS_TILE_ROWS[dtype])
    words = prog.encode()
    assert prog.slots <= window.TAPS_MAX_SLOTS
    assert len(prog.instrs) <= window.TAPS_MAX_INSTRS
    assert sum(len(t) for *_, t in prog.instrs) <= window.TAPS_MAX_TERMS
    assert words[:5] == [prog.hy, prog.hx, prog.margin, prog.slots,
                         len(prog.instrs)]
    assert prog.hx <= prog.margin and prog.margin in (4, 8)
    assert prog.instrs[-1][:3] == (-1, prog.hy, prog.hy + prog.rows)


def test_program_picks_its_tables_by_cost():
    # Every run length 1..17 at once would need 17 tables; the power-of-two
    # decomposition needs five.
    assert window.taps_program(named_taps("stairs-17x17"), 32).tables == (
        2, 4, 8, 16)
    # The diamond's run of five is two runs of three: one table, not two.
    diamond = window.taps_program(named_taps("diamond-5x5"), 32)
    assert diamond.tables == (3,)
    exact = window._compile(window.tap_runs(named_taps("diamond-5x5")), 32)
    assert diamond.cost() < exact.cost()
    assert window.taps_program(named_taps("square-17x17"), 32).tables == (
        3, 5, 9, 17)


# -- the decomposition, runs then rows --------------------------------------

def evaluate_runs(planar: torch.Tensor, runs, reduce) -> torch.Tensor:
    """The descriptor evaluated on the whole buffer: each table H_L by its
    builds, then each output the reduction over its rows' terms; 0 in the
    ring."""
    hy, hx = runs.hy, runs.hx
    if window._no_interior(planar, hy, hx):
        return torch.zeros_like(planar)
    _, hp, pitch = planar.shape
    tables = {1: planar}

    def shifted(t: torch.Tensor, s: int) -> torch.Tensor:
        return torch.cat([t[..., s:], t[..., :s]], dim=-1)  # wraps: unused

    for length, terms in runs.builds:
        acc = None
        for a, s in terms:
            t = shifted(tables[a], s)
            acc = t if acc is None else reduce(acc, t)
        tables[length] = acc
    core = None
    for dy, row in enumerate(runs.rows):
        for length, dx in row:
            t = tables[length][:, dy:hp - 2 * hy + dy,
                               hx + dx:pitch - hx + dx]
            core = t if core is None else reduce(core, t)
    return window._framed(core, planar, hy, hx)


@pytest.mark.parametrize("tables", [None, "pow2"])
@pytest.mark.parametrize("which", ["erosion", "dilation"])
@pytest.mark.parametrize("name", ["diamond-5x5", "ring-5x5", "square-5x5",
                                  "row-1x5", "single-corner"])
def test_decomposition_matches_jax_and_plain(name, which, tables,
                                             small_image):
    taps = named_taps(name)
    reduce = torch.minimum if which == "erosion" else torch.maximum
    jax_layout = jax_image.make_layout(*small_image.shape[:2])
    jax_planar = jax_image.to_planar_padded(small_image, jax_layout)
    jax_make = (jax_window.make_erosion if which == "erosion"
                else jax_window.make_dilation)
    want = jax_image.from_planar_padded(np.asarray(jax_make(
        jax_layout, taps)(jax.device_put(jax_planar))), jax_layout)
    layout = make_layout(*small_image.shape[:2])
    planar = from_jax_planar(jax_planar, jax_layout)
    got = evaluate_runs(planar, window.tap_runs(taps, tables), reduce)
    assert torch.equal(got, window.morphology_plain(planar, taps, reduce))
    p = layout.pad
    h, w = small_image.shape[:2]
    np.testing.assert_array_equal(
        got[:, p:p + h, p:p + w].permute(1, 2, 0).numpy(), want)


@pytest.mark.parametrize("name", ["diamond-5x5", "ring-5x5", "row-1x5"])
def test_float32_decomposition_matches_jax_erosion(name, small_image):
    taps = named_taps(name)
    h, w, _ = small_image.shape
    jax_layout = jax_image.make_layout(h, w, itemsize=4)
    jax_planar = jax_image.to_planar_padded_f32(small_image, jax_layout)
    out = np.asarray(jax_f32._make_erosion(jax_layout, taps)(
        jax.device_put(jax_planar)))
    layout = make_layout(h, w)
    planar = from_jax_planar(jax_planar, jax_layout)
    got = evaluate_runs(planar, window.tap_runs(taps), torch.minimum)
    assert torch.equal(got, window.morphology_plain(planar, taps,
                                                    torch.minimum))
    p = layout.pad
    want = from_jax_planar(out, jax_layout)[:, p:p + h, p:p + w]
    assert torch.equal(got[:, p:p + h, p:p + w], want)


# -- the program, as the kernels run it -------------------------------------

def emulate_program(planar: np.ndarray, prog, reduce) -> np.ndarray:
    """The Taps kernels' arithmetic on a (C, Hp, pitch) array, tile by
    tile: the frame loaded with 0 outside the buffer, each instruction over
    its rows and every frame position, NaN wherever the kernel would read a
    value it must not use, the output stored with the ring zeroed."""
    c, hp, pitch = planar.shape
    rows, frame = prog.rows, window.TAPS_FRAME
    hy, hx, margin = prog.hy, prog.hx, prog.margin
    fr = rows + 2 * hy
    cols = frame - 2 * margin
    src = np.zeros((c, hp + fr + rows, pitch + 2 * frame))
    src[:, hy:hy + hp, margin:margin + pitch] = planar
    out = np.zeros((c, hp, pitch))
    for y0 in range(0, hp, rows):
        for x0 in range(0, pitch, cols):
            slots = np.full((prog.slots, c, fr, frame), np.nan)
            slots[0] = src[:, y0:y0 + fr, x0:x0 + frame]
            for dst, r0, r1, terms in prog.instrs:
                acc = None
                for slot, dy, dx in terms:
                    t = np.full((c, r1 - r0, frame), np.nan)
                    lo, hi = max(0, -dx), min(frame, frame - dx)
                    t[..., lo:hi] = slots[slot][:, r0 + dy:r1 + dy,
                                                lo + dx:hi + dx]
                    acc = t if acc is None else reduce(acc, t)
                if dst >= 0:
                    slots[dst] = np.nan
                    slots[dst][:, r0:r1] = acc
            ys = slice(y0, min(y0 + rows, hp))
            xs = slice(x0, min(x0 + cols, pitch))
            n_y, n_x = ys.stop - ys.start, xs.stop - xs.start
            out[:, ys, xs] = acc[:, :n_y, margin:margin + n_x]
    assert not np.isnan(out[:, hy:hp - hy, hx:pitch - hx]).any()
    out = np.nan_to_num(out)
    out[:, :hy] = out[:, hp - hy:] = 0
    out[..., :hx] = out[..., pitch - hx:] = 0
    return out


def check_emulation(taps, planar: torch.Tensor) -> None:
    prog = window.taps_program(tuple(taps), window.TAPS_TILE_ROWS[
        "float32" if planar.dtype == torch.float32 else "uint8"])
    for reduce, plain in ((np.minimum, torch.minimum),
                          (np.maximum, torch.maximum)):
        got = emulate_program(planar.double().numpy(), prog, reduce)
        want = window.morphology_plain(planar, taps, plain)
        np.testing.assert_array_equal(got, want.double().numpy())


@pytest.mark.parametrize("name", ALL_NAMES)
def test_program_emulation_matches_plain(name):
    taps = named_taps(name)
    rng = np.random.default_rng(5)
    layout = make_layout(70, 150, pad=8)   # two tiles across, two down
    image = rng.integers(0, 256, (70, 150, 3), np.uint8)
    check_emulation(taps, to_planar_padded(image, layout))
    check_emulation(taps, to_planar_padded_f32(image, layout))


@pytest.mark.parametrize("seed", SEEDS)
def test_program_emulation_matches_plain_on_random_elements(seed):
    taps = random_element(seed)
    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(9, 40)), int(rng.integers(9, 140))
    layout = make_layout(h, w, pad=8)
    check_emulation(taps, to_planar_padded(
        rng.integers(0, 256, (h, w, 3), np.uint8), layout))
    check_emulation(taps, to_planar_padded_f32(
        rng.integers(0, 256, (h, w, 3), np.uint8), layout))


def test_kernel_constants_equal_the_planner():
    # taps.cuh compiles the tile and the program's limits in; the planner
    # builds programs (and the emulation models tiles) to the same numbers.
    with open(os.path.join(build.CSRC, "taps.cuh")) as f:
        consts = {m[0]: int(m[1]) for m in re.findall(
            r"constexpr int (kTaps\w+) = (\d+);", f.read())}
    assert (consts["kTapsRowsU8"], consts["kTapsRowsF32"]) == (
        window.TAPS_TILE_ROWS["uint8"], window.TAPS_TILE_ROWS["float32"])
    assert consts["kTapsFrame"] == window.TAPS_FRAME
    assert consts["kTapsMaxSlots"] == window.TAPS_MAX_SLOTS
    assert consts["kTapsMaxInstrs"] == window.TAPS_MAX_INSTRS
    assert consts["kTapsMaxTerms"] == window.TAPS_MAX_TERMS
    assert consts["kTapsMaxRadius"] == window.MAX_TAP_RADIUS


def test_launch_arguments_carry_the_program():
    taps = named_taps("diamond-5x5")
    name, entry, (words, n) = window.morphology_launch(taps, "max")
    assert (name, entry) == ("window_u8<Taps<Max>>", "dip_dilation_taps_u8")
    assert list(words) == window.taps_program(
        taps, window.TAPS_TILE_ROWS["uint8"]).encode() and n == len(words)
    # A square wider than 3x3 routes to Taps, as every element of another
    # extent does.
    square = window.morphology_launch(named_taps("square-5x5"), "min",
                                      "float32")
    assert square[:2] == ("window_f32<Taps<Min>>", "dip_erosion_taps_f32")
    with pytest.raises(ValueError, match="exceeds the kernels"):
        window.morphology_launch(((0, 9), (0, 0)), "min")


def test_cpu_tensors_launch_no_kernel_for_large_elements():
    layout = make_layout(20, 30, pad=8)
    planar = torch.zeros(layout.shape, dtype=torch.uint8)
    kernels.reset_launches()
    for name in ("square-17x17", "checker-17x17", "disc-9x9"):
        window.make_erosion(layout, named_taps(name))(planar)
    assert kernels.LAUNCHES == {}


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(8))
def test_random_elements_match_plain_on_card(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    taps = random_element(100 + seed)
    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(9, 80)), int(rng.integers(9, 300))
    layout = make_layout(h, w, pad=8)
    image = rng.integers(0, 256, (h, w, 3), np.uint8)
    for make, bake, reduce in (
            (window.make_dilation, to_planar_padded, torch.maximum),
            (window.make_erosion, to_planar_padded, torch.minimum),
            (f32.make_erosion, to_planar_padded_f32, torch.minimum)):
        planar = bake(image, layout).cuda()
        got = make(layout, taps)(planar)
        torch.cuda.synchronize()
        assert torch.equal(got, window.morphology_plain(planar, taps, reduce))
