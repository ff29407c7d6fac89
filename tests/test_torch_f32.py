"""The float32 data model of the port (K12–K16) against the JAX package's
Pallas f32 ops and the port's f32 oracle.

The JAX ops run as tests/test_f32_path.py runs them (Pallas interpret mode
on the CPU) on the JAX f32 planar (``make_layout(..., itemsize=4)``); the
port gets the identical buffer through from_jax_planar and, on CPU
tensors, runs each op's plain PyTorch version. The JAX kernels leave rows
outside their bands unwritten, so they are compared on the crop only.
Tolerance ``atol=3e-7`` on [0, 1] values, as in tests/test_f32_path.py:
XLA may contract a multiply-add into an FMA (2 ulp). The card-only tests at
the end hold the CUDA kernels against the same plain versions at
tolerance 0, the convolution bodies also at edge shapes with random masks;
they skip without a CUDA device.
"""

import os

import jax
import numpy as np
import pytest
import torch

from dip_benchmark_tpu import cli as jax_cli
from dip_benchmark_tpu import spec
from dip_benchmark_tpu.ops import pallas
from dip_benchmark_tpu.ops.pallas import f32 as jax_f32
from dip_benchmark_tpu.utils import image as jax_image
from dip_benchmark_tpu_torch import cli, oracle_f32
from dip_benchmark_tpu_torch.ops import (OPS, OPS_F32, PLAIN_F32, f32,
                                         kernels)
from dip_benchmark_tpu_torch.session import BenchmarkSession
from dip_benchmark_tpu_torch.utils.image import (from_jax_planar,
                                                 from_planar_padded_f32,
                                                 load_image, make_layout,
                                                 mirror_cols, mirror_rows,
                                                 save_image,
                                                 to_planar_padded,
                                                 to_planar_padded_f32)

COLS = sorted(OPS_F32)
POINT_COLS = ("Copy", "Inversion", "Grayscale", "Threshold")
RADIUS = {"Convolution-5x5": 2, "Convolution-1x5+5x1": 2,
          "Fused-Pipeline": 2}  # others: 1
ATOL = 3e-7  # tests/test_f32_path.py:65


def random_image(hw, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, hw + (3,), np.uint8)


def jax_f32_planar(image: np.ndarray):
    jax_layout = jax_image.make_layout(*image.shape[:2], itemsize=4)
    return jax_image.to_planar_padded_f32(image, jax_layout), jax_layout


def crop(planar: torch.Tensor, layout) -> np.ndarray:
    """The valid (C, H, W) float32 region."""
    p = layout.pad
    return planar[:, p:p + layout.height, p:p + layout.width].numpy()


def run_port(col: str, image: np.ndarray) -> np.ndarray:
    layout = make_layout(*image.shape[:2])
    return crop(OPS_F32[col](to_planar_padded_f32(image, layout)), layout)


def test_registry_keys_equal_jax_build_f32_ops():
    jax_cols = set(pallas.build_f32_ops(
        jax_image.make_layout(8, 8, itemsize=4)))
    assert set(OPS_F32) == set(PLAIN_F32) == jax_cols == set(OPS)
    assert set(OPS_F32) == set(oracle_f32.IMAGE_OPS_F32)


@pytest.mark.parametrize("col", COLS)
def test_port_matches_jax_pallas_f32(col, small_image):
    jax_planar, jax_layout = jax_f32_planar(small_image)
    jax_out = pallas.build_f32_ops(jax_layout)[col](
        jax.device_put(jax_planar))
    want_u8 = pallas.build_f32_crops(jax_layout)[col](jax_out)
    layout = make_layout(*small_image.shape[:2])
    want = crop(from_jax_planar(np.asarray(jax_out), jax_layout), layout)

    out = OPS_F32[col](from_jax_planar(jax_planar, jax_layout))
    assert out.dtype == torch.float32 and out.shape == layout.shape
    np.testing.assert_allclose(crop(out, layout), want, rtol=0, atol=ATOL,
                               err_msg=col)
    got_u8 = from_planar_padded_f32(out, layout)
    assert np.abs(got_u8.astype(int) - want_u8.astype(int)).max() <= 1


def test_batched_pipeline_matches_jax_batched_pallas():
    hw = (24, 40)
    images = [random_image(hw, seed=s) for s in (1, 2, 3)]
    jax_layout = jax_image.make_layout(*hw, itemsize=4)
    jax_stack = np.stack([jax_image.to_planar_padded_f32(im, jax_layout)
                          for im in images])
    jax_out = np.asarray(jax_f32._make_pipeline(jax_layout, batch=3)(
        jax.device_put(jax_stack)))
    stack = from_jax_planar(jax_stack, jax_layout)
    out = f32.fused_pipeline(stack)
    layout = make_layout(*hw)
    want = from_jax_planar(jax_out, jax_layout)
    for b in range(3):
        np.testing.assert_allclose(crop(out[b], layout),
                                   crop(want[b], layout), rtol=0, atol=ATOL)
        # A batch is its images, one by one.
        assert torch.equal(out[b], f32.fused_pipeline(stack[b]))


@pytest.mark.parametrize("fixture", ["gradient_image", "fundus_crop"])
@pytest.mark.parametrize("col", COLS)
def test_port_matches_oracle_f32(col, fixture, request):
    image = request.getfixturevalue(fixture)
    want = oracle_f32.IMAGE_OPS_F32[col](oracle_f32.from_uint8_hwc(image))
    np.testing.assert_allclose(run_port(col, image), want, rtol=0,
                               atol=ATOL, err_msg=col)


@pytest.mark.parametrize("col", COLS)
def test_port_matches_oracle_f32_smallest_image(col):
    image = random_image((5, 5), seed=5)
    want = oracle_f32.IMAGE_OPS_F32[col](oracle_f32.from_uint8_hwc(image))
    np.testing.assert_allclose(run_port(col, image), want, rtol=0,
                               atol=ATOL, err_msg=col)


@pytest.mark.parametrize("col", POINT_COLS)
def test_f32_point_ops_keep_the_mirror_halo(col, small_image):
    # Point ops run over the whole buffer and commute with mirroring:
    # every padded element equals the image element it mirrors.
    layout = make_layout(*small_image.shape[:2])
    out = OPS_F32[col](to_planar_padded_f32(small_image, layout))
    ys = torch.from_numpy(mirror_rows(layout) + layout.pad)
    xs = torch.from_numpy(mirror_cols(layout) + layout.pad)
    assert torch.equal(out, out[:, ys[:, None], xs[None, :]])


@pytest.mark.parametrize("col", sorted(set(COLS) - set(POINT_COLS)))
def test_f32_window_ops_write_a_zero_ring(col, gradient_image):
    # Every channel > 0.5, so no op gives 0 inside: the ring is the only
    # zero region.
    image = 255 - gradient_image // 2
    layout = make_layout(*image.shape[:2])
    out = OPS_F32[col](to_planar_padded_f32(image, layout))
    r = RADIUS.get(col, 1)
    inner = torch.zeros_like(out, dtype=torch.bool)
    inner[:, r:-r, r:-r] = True
    assert not bool(out[~inner].any())
    assert bool(out[inner].all())


@pytest.mark.parametrize("hw", [(37, 53), (5, 5), (64, 80)])
def test_pipeline_outputs_are_multiples_of_a_sixteenth(hw):
    layout = make_layout(*hw)
    images = [random_image(hw, seed=s) for s in (7, 8)]
    stack = torch.stack([to_planar_padded_f32(im, layout) for im in images])
    out = f32.fused_pipeline(stack)
    sixteenths = out * 16
    assert torch.equal(sixteenths, torch.round(sixteenths))
    assert float(out.min()) >= 0 and float(out.max()) <= 1
    # The one result goes to all three planes.
    assert torch.equal(out[:, 0], out[:, 1]) and torch.equal(out[:, 0],
                                                             out[:, 2])


def test_luma_of_exactly_one_half_thresholds_to_zero():
    # rgb (126, 139, 18): the luma is exactly 0.5 in NumPy's order, and
    # the threshold is "> 0.5", so the pipeline gives 0 everywhere.
    image = np.broadcast_to(np.array([126, 139, 18], np.uint8),
                            (9, 11, 3)).copy()
    x = oracle_f32.from_uint8_hwc(image)
    assert (oracle_f32.grayscale(x) == np.float32(0.5)).all()
    layout = make_layout(9, 11)
    planar = to_planar_padded_f32(image, layout)
    gray = f32.grayscale_plain(planar)
    assert bool((gray == 0.5).all())
    assert not bool(f32.threshold_plain(gray).any())
    assert not bool(f32.fused_pipeline(planar).any())
    # One level brighter in green crosses the step.
    image[..., 1] = 140
    out = f32.fused_pipeline(to_planar_padded_f32(image, layout))
    assert bool((crop(out, layout)[:, 2:-2, 2:-2] == 1).all())


def test_separable_convolution_does_not_round_between_passes(fundus_crop):
    # Unlike the uint8 model, no pass quantizes: the result is not on the
    # 1/255 grid the uint8 model's would be.
    layout = make_layout(*fundus_crop.shape[:2])
    out = crop(OPS_F32["Convolution-1x5+5x1"](
        to_planar_padded_f32(fundus_crop, layout)), layout)
    levels = out * np.float32(255)
    assert np.abs(levels - np.rint(levels)).max() > 0.1


@pytest.mark.parametrize("col", ["Copy", "Convolution-5x5",
                                 "Fused-Pipeline", "Grayscale"])
def test_check_planar_refuses_a_mixed_dtype(col, small_image):
    layout = make_layout(*small_image.shape[:2])
    u8 = to_planar_padded(small_image, layout)
    f = to_planar_padded_f32(small_image, layout)
    with pytest.raises(ValueError, match="float32 tensor"):
        OPS_F32[col](u8)
    with pytest.raises(ValueError, match="uint8 tensor"):
        OPS[col](f)
    with pytest.raises(ValueError, match="float32 tensor"):
        kernels.check_planar(f.double(), dtype=torch.float32)


@pytest.mark.parametrize("masks", [
    (np.ones((3, 5), np.int32), None),
    (np.ones((7, 7), np.int32), None),
    (spec.BLUR_1X3_INT, spec.BLUR_5X1_INT),
])
def test_f32_convolution_refuses_masks_without_a_kernel(masks, small_image):
    planar = to_planar_padded_f32(small_image,
                                  make_layout(*small_image.shape[:2]))
    row, col = masks
    with pytest.raises(ValueError, match="no .*kernel"):
        if col is None:
            f32.convolution(planar, row, 4)
        else:
            f32.convolution_separated(planar, row, col, 2)


@pytest.mark.parametrize("hw", [(37, 53), (5, 5), (24, 40)])
def test_bake_and_crop_equal_the_jax_package(hw):
    image = random_image(hw, seed=sum(hw))
    jax_planar, jax_layout = jax_f32_planar(image)
    layout = make_layout(*hw)
    planar = to_planar_padded_f32(image, layout)
    assert planar.dtype == torch.float32 and planar.shape == layout.shape
    assert layout.pitch % 16 == 0
    # Bit-equal to the re-cut of the JAX package's f32 bake.
    assert torch.equal(planar, from_jax_planar(jax_planar, jax_layout))
    # Its crop is the image, and a crop of any output is the JAX crop.
    np.testing.assert_array_equal(from_planar_padded_f32(planar, layout),
                                  image)
    scaled = jax_planar * np.float32(0.37)
    np.testing.assert_array_equal(
        from_planar_padded_f32(from_jax_planar(scaled, jax_layout), layout),
        pallas.build_f32_crops(jax_layout)["Copy"](scaled))
    # A stack crops image by image.
    stack = torch.stack([planar, planar])
    np.testing.assert_array_equal(from_planar_padded_f32(stack, layout),
                                  np.stack([image, image]))


def test_f32_session_state(small_image):
    session = BenchmarkSession(small_image, "cpu", dtype="float32")
    payload = oracle_f32.from_uint8_hwc(small_image)
    assert session.image_dev.dtype == torch.float32
    np.testing.assert_array_equal(session.image_dev.numpy(), payload)
    assert session.planar_dev.dtype == torch.float32
    assert tuple(session.planar_dev.shape) == session.layout.shape
    assert session.verify_atol == 1
    assert BenchmarkSession(small_image, "cpu").verify_atol == 0
    assert (session.oracle_ops()["Fused-Pipeline"].__qualname__
            == oracle_f32.uint8_verify_ops()["Fused-Pipeline"].__qualname__)
    with pytest.raises(ValueError, match="Unknown dtype"):
        BenchmarkSession(small_image, "cpu", dtype="float16")


def test_f32_memory_payload_is_contiguous_chw(small_image):
    # Upload moves the (3, H, W) array row-major, as the JAX package's
    # device_put holds it, and Download returns it the same way.
    h, w, _ = small_image.shape
    session = BenchmarkSession(small_image, "cpu", dtype="float32")
    assert tuple(session._mem_host.shape) == (3, h, w)
    assert session._mem_host.is_contiguous()
    assert session._mem_host.numpy().flags["C_CONTIGUOUS"]
    assert session._upload().is_contiguous()
    got = session._download()
    assert got.flags["C_CONTIGUOUS"] and got.shape == (3, h, w)
    np.testing.assert_array_equal(got, oracle_f32.from_uint8_hwc(small_image))


def table_rows(text: str) -> list[str]:
    return [ln for ln in text.splitlines() if ln.startswith("| ")]


def test_cli_float32_end_to_end_matches_jax_cli(tmp_path, small_image,
                                                capsys):
    img = str(tmp_path / "small.png")
    save_image(img, small_image)
    common = ["--rounds", "2", "--backend", "cpu", "--dtype", "float32",
              "--verify", "--warmup", "0", "--pipeline"]
    port_out, csv = tmp_path / "port", str(tmp_path / "r.csv")
    assert cli.main([img, str(port_out), *common, "--csv", csv]) == 0
    rows = table_rows(capsys.readouterr().out)
    assert len(rows) == 15
    dumps = sorted(os.listdir(port_out))
    assert len(dumps) == 13
    with open(csv) as f:
        lines = f.read().splitlines()
    assert lines[0] == spec.CSV_HEADER and lines[1].startswith("CPU-torch,")
    assert len(lines[1].split(",")) == len(spec.CSV_COLUMNS) + 1

    jax_out = tmp_path / "jax"
    assert jax_cli.main([img, str(jax_out), *common, "--path",
                         "pallas"]) == 0
    jax_rows = table_rows(capsys.readouterr().out)
    assert [r.split("|")[1] for r in rows] == [
        r.split("|")[1] for r in jax_rows]
    assert dumps == sorted(os.listdir(jax_out))
    for name in dumps:
        a = load_image(str(port_out / name)).astype(int)
        b = load_image(str(jax_out / name)).astype(int)
        assert np.abs(a - b).max() <= 1, name


def test_cli_uint8_stays_the_default(tmp_path, small_image, capsys):
    img = str(tmp_path / "small.png")
    save_image(img, small_image)
    assert cli.main([img, str(tmp_path / "out"), "--rounds", "1",
                     "--backend", "cpu", "--verify"]) == 0
    assert cli.build_parser().parse_args([img, str(tmp_path)]).dtype == \
        "uint8"
    # The uint8 Threshold dump is binary 0/255, the model's, not f32's.
    out = load_image(str(tmp_path / "out" / "threshold-small.png"))
    assert set(np.unique(out)) <= {0, 255}


@pytest.mark.cuda
@pytest.mark.parametrize("col", COLS)
def test_f32_kernel_matches_plain_on_card(col, small_image, fundus_crop):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    verify = oracle_f32.uint8_verify_ops()[col]
    for image in (small_image, fundus_crop):
        layout = make_layout(*image.shape[:2])
        planar = to_planar_padded_f32(image, layout).cuda()
        got = OPS_F32[col](planar)
        torch.cuda.synchronize()
        assert got.is_cuda
        assert torch.equal(got, PLAIN_F32[col](planar))
        expected = verify(image)
        mask = None
        if isinstance(expected, tuple):
            expected, mask = expected
        delta = np.abs(from_planar_padded_f32(got, layout).astype(int)
                       - expected.astype(int))
        if mask is not None:
            delta[mask] = 0
        assert delta.max() <= 1


EDGES = [f"{h}x{w}" for h, w in ((3, 3), (3, 12), (5, 28), (64, 124),
                                 (2341, 3501))] + [
    "raw (3, 3, 16)", "raw (1, 70, 4112)"]


@pytest.mark.cuda
@pytest.mark.parametrize("edge", EDGES)
def test_f32_strip_bodies_match_plain_on_card_at_edges(edge):
    # chip_smoke.py phase 3h: window_f32_strip's bodies with random float
    # masks, whole buffer, tolerance 0.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    import chip_smoke
    rng = np.random.default_rng(EDGES.index(edge))
    if edge.startswith("raw"):
        shape = tuple(int(s) for s in edge[5:-1].split(","))
        planar = torch.from_numpy(rng.random(shape, dtype=np.float32))
    else:
        h, w = (int(s) for s in edge.split("x"))
        planar = to_planar_padded_f32(
            rng.integers(0, 256, (h, w, 3), np.uint8), make_layout(h, w))
    planar = planar.cuda()
    for what, name, fn, plain in chip_smoke.f32_edge_bodies(rng):
        got = fn(planar)
        torch.cuda.synchronize()
        assert torch.equal(got, plain(planar)), f"{name} ({what}) on {edge}"
