"""The port's batch tool (models/batch.py) against the oracle and the JAX
package's batch tool, on the CPU, and its chunk rule; the card tests
(``-m cuda``) against the oracle. Tolerance 0: the uint8 model is
bit-exact by spec. Without JAX (the card's machine) the card tests still
run:

    python -m pytest --noconftest tests/test_torch_batch.py -m cuda
"""

import numpy as np
import pytest
import torch

from dip_benchmark_tpu_torch import oracle
from dip_benchmark_tpu_torch.models import batch, chain
from dip_benchmark_tpu_torch.ops import kernels
from dip_benchmark_tpu_torch.runtime import tracing
from dip_benchmark_tpu_torch.utils.image import load_image, save_image

try:
    from dip_benchmark_tpu.models import batch as jax_batch
except ImportError:   # a machine with a card and no JAX runs the card tests
    jax_batch = None

needs_jax = pytest.mark.skipif(jax_batch is None,
                               reason="compares with the JAX package, "
                                      "which is not installed")
FUNDUS = (2336, 3504, 3)
C3 = ["Convolution-1x5+5x1", "Erosion-3x3-Cross"]


def stack(shape, seed=0, n=3) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n,) + shape,
                                                np.uint8)


def write_dir(path, images: dict) -> None:
    path.mkdir()
    for name, img in images.items():
        save_image(str(path / name), img)


@needs_jax
def test_process_batch_pipeline_matches_oracle_and_jax():
    imgs = stack((24, 40, 3), seed=1)
    kernels.reset_launches()
    got = batch.process_batch(imgs, device="cpu")
    assert kernels.LAUNCHES == {}  # CPU tensors: the plain version
    assert got.shape == imgs.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jax_batch.process_batch(
        imgs, "Fused-Pipeline"))
    for b in range(3):
        np.testing.assert_array_equal(got[b], oracle.fused_pipeline(imgs[b]))


@pytest.mark.parametrize("col", ["Grayscale", "Erosion-1x3+3x1-Square",
                                 "Convolution-5x5"])
def test_process_batch_single_op_matches_oracle(col):
    imgs = stack((16, 24, 3), seed=2, n=2)
    got = batch.process_batch(imgs, col, device="cpu")
    for b in range(2):
        np.testing.assert_array_equal(got[b], oracle.IMAGE_OPS[col](imgs[b]))


# Image bytes just under and just over the chunk floor: rows of one pixel.
UNDER = (1, (batch.CHUNK_BYTES - 1) // 3, 3)
OVER = (1, batch.CHUNK_BYTES // 3 + 1, 3)


@pytest.mark.parametrize("shape, per", [
    ((1,) + FUNDUS, 2), ((3,) + FUNDUS, 2), ((8,) + FUNDUS, 2),
    ((3, 37, 53, 3), 3), ((5,) + UNDER, 2), ((5,) + OVER, 1),
    ((1,) + UNDER, 1),
])
def test_chunks_are_the_fewest_images_that_reach_the_floor(shape, per):
    got = batch.chunks(shape)
    assert got == tuple((i, min(i + per, shape[0]))
                        for i in range(0, shape[0], per))
    assert all(np.prod(shape[1:]) * (stop - start) >= batch.CHUNK_BYTES
               for start, stop in got[:-1])
    assert all(np.prod(shape[1:]) * (stop - start - 1) < batch.CHUNK_BYTES
               for start, stop in got)


@pytest.mark.parametrize("shape", [
    (1,) + FUNDUS, (7,) + FUNDUS, (3, 37, 53, 3), (9,) + UNDER,
    (4,) + OVER, (11, 1024, 1024, 3), (6, 1500, 1500, 3),
])
def test_chunks_cover_every_image_once_in_order(shape):
    got = batch.chunks(shape)
    assert [i for start, stop in got for i in range(start, stop)] == list(
        range(shape[0]))
    assert all(stop > start for start, stop in got)


def test_a_cpu_stack_is_one_chunk_whatever_its_size(monkeypatch):
    imgs = stack((16, 24, 3), seed=9, n=4)
    want = batch.process_batch(imgs, device="cpu")
    monkeypatch.setattr(batch, "CHUNK_BYTES", 1)
    assert len(batch.chunks(imgs.shape)) == 4
    tracing.enable()
    try:
        got = batch.process_batch(imgs, device="cpu")
        snap = tracing.snapshot()
    finally:
        tracing.disable()
    assert snap.counters["batch_chunks"] == 1
    assert "fetch" not in snap.spans
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("images", [
    np.zeros((0, 8, 8, 3), np.uint8),
    np.zeros((2, 8, 8, 4), np.uint8),
    np.zeros((2, 8, 8, 3), np.float32),
    np.zeros((8, 8, 3), np.uint8),
])
def test_process_batch_refuses_a_bad_stack(images):
    with pytest.raises(ValueError, match="stack"):
        batch.process_batch(images, device="cpu")


@pytest.mark.parametrize("col", ["Upload", "Grayscale,Threshold", "Nope"])
def test_process_batch_refuses_an_unknown_op(col):
    with pytest.raises(ValueError, match="no batch op"):
        batch.process_batch(stack((8, 8, 3)), col, device="cpu")


def test_process_batch_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(batch.DeviceGateError, match="No CUDA device"):
        batch.process_batch(stack((8, 8, 3)))


def test_process_directory_mixed_shapes(tmp_path):
    shapes = [(16, 24, 3), (16, 24, 3), (32, 40, 3), (16, 24, 3)]
    imgs = {f"img{i}.png": stack(s, seed=i, n=1)[0]
            for i, s in enumerate(shapes)}
    write_dir(tmp_path / "in", imgs)
    written = batch.process_directory(str(tmp_path / "in"),
                                      str(tmp_path / "out"), batch_size=2,
                                      device="cpu")
    assert len(written) == 4
    for name, img in imgs.items():
        np.testing.assert_array_equal(load_image(str(tmp_path / "out" / name)),
                                      oracle.fused_pipeline(img))


def test_process_directory_header_decode_shape_mismatch(tmp_path,
                                                        monkeypatch):
    # The decoder applies an orientation the header probe does not see: the
    # chunk regroups by the decoded shape instead of failing to stack.
    a, b = stack((16, 24, 3), seed=3, n=2)
    write_dir(tmp_path / "in", {"a.png": a, "b.png": b})
    bt = np.ascontiguousarray(b.transpose(1, 0, 2))
    real = batch.load_image
    monkeypatch.setattr(batch, "load_image", lambda path: (
        bt if path.endswith("b.png") else real(path)))
    written = batch.process_directory(str(tmp_path / "in"),
                                      str(tmp_path / "out"), "Inversion",
                                      batch_size=2, device="cpu")
    assert len(written) == 2
    np.testing.assert_array_equal(load_image(str(tmp_path / "out" / "a.png")),
                                  oracle.inversion(a))
    np.testing.assert_array_equal(load_image(str(tmp_path / "out" / "b.png")),
                                  oracle.inversion(bt))


def test_process_directory_overlaps_dispatch_and_fetch(tmp_path,
                                                      monkeypatch):
    # Chunk n is dispatched before chunk n - 1 is fetched.
    write_dir(tmp_path / "in", {f"img{i}.png": im for i, im in
                                enumerate(stack((16, 24, 3), seed=4))})
    events = []
    real_dispatch, real_fetch = batch._dispatch_batch, batch._fetch_batch
    monkeypatch.setattr(batch, "_dispatch_batch", lambda im, col, dev: (
        events.append(("dispatch", len(im))), real_dispatch(im, col, dev))[1])
    monkeypatch.setattr(batch, "_fetch_batch", lambda token: (
        events.append(("fetch",)), real_fetch(token))[1])
    written = batch.process_directory(str(tmp_path / "in"),
                                      str(tmp_path / "out"), "Inversion",
                                      batch_size=1, device="cpu")
    assert len(written) == 3
    assert events == [("dispatch", 1), ("dispatch", 1), ("fetch",),
                      ("dispatch", 1), ("fetch",), ("fetch",)]


@needs_jax
def test_main_matches_the_jax_batch_tool(tmp_path, capsys):
    imgs = {f"im{i}.png": im for i, im in
            enumerate(stack((20, 28, 3), seed=5))}
    imgs["odd.png"] = stack((12, 9, 3), seed=6, n=1)[0]
    write_dir(tmp_path / "in", imgs)
    (tmp_path / "in" / "notes.txt").write_text("not an image")
    assert batch.main([str(tmp_path / "in"), str(tmp_path / "port"),
                       "--batch-size", "2", "--backend", "cpu"]) == 0
    assert "Processed 4 images" in capsys.readouterr().out
    assert jax_batch.main([str(tmp_path / "in"), str(tmp_path / "jax"),
                           "--batch-size", "2", "--backend", "cpu"]) == 0
    for name, img in imgs.items():
        got = load_image(str(tmp_path / "port" / name))
        np.testing.assert_array_equal(got, oracle.fused_pipeline(img))
        np.testing.assert_array_equal(
            got, load_image(str(tmp_path / "jax" / name)))


def test_main_single_op(tmp_path):
    imgs = {"a.png": stack((10, 14, 3), seed=7, n=1)[0]}
    write_dir(tmp_path / "in", imgs)
    assert batch.main([str(tmp_path / "in"), str(tmp_path / "out"),
                       "--op", "Grayscale", "--backend", "cpu"]) == 0
    np.testing.assert_array_equal(load_image(str(tmp_path / "out" / "a.png")),
                                  oracle.grayscale(imgs["a.png"]))


@pytest.mark.parametrize("args, says", [
    (["--shards", "2", "--op", "Grayscale"],
     "--shards applies to chain/pipeline ops only"),
    (["--data-shards", "2"], "--data-shards needs --shards"),
    (["--op", "Inversion,Grayscale"], "--op chain"),
    (["--op", "Upload"], "--op must be one of"),
    (["--batch-size", "0"], "--batch-size"),
])
def test_main_refuses_with_exit_2(args, says, tmp_path, capsys):
    (tmp_path / "in").mkdir()
    assert batch.main([str(tmp_path / "in"), str(tmp_path / "out"), *args,
                       "--backend", "cpu"]) == 2
    assert says in capsys.readouterr().err
    assert not (tmp_path / "out").exists()


def test_main_without_a_card_exits_4(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    write_dir(tmp_path / "in", {"a.png": stack((8, 8, 3), n=1)[0]})
    assert batch.main([str(tmp_path / "in"), str(tmp_path / "out")]) == 4
    assert "No CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "out").exists()


@pytest.mark.cuda
@pytest.mark.parametrize("col", ["Fused-Pipeline", "Grayscale"])
def test_process_batch_on_card(col):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    imgs = stack((37, 53, 3), seed=8)
    kernels.reset_launches()
    got = batch.process_batch(imgs, col)
    # The pipeline bakes the stack on the card, runs, then crops: three
    # launches. A single op of the matrix runs on the library path: no
    # kernel.
    assert sum(kernels.LAUNCHES.values()) == (3 if col == "Fused-Pipeline"
                                              else 0)
    for b in range(3):
        np.testing.assert_array_equal(got[b], oracle.IMAGE_OPS[col](imgs[b]))


@pytest.mark.cuda
@pytest.mark.parametrize("cols", ["Fused-Pipeline", C3],
                         ids=["pipeline", "C3"])
def test_process_batch_on_card_chunks_large_stacks(cols):
    # Three fundus-sized images are two chunks, of two images and one: a
    # bake, a kernel and a crop launch each, each chunk's copy back on the
    # copy stream.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    if cols == "Fused-Pipeline":
        kernel, want = "pipeline_u8", oracle.fused_pipeline
    else:
        kernel, want = "chain_u8", chain.chain_row_parts(cols)[2]
    first, second = stack(FUNDUS, seed=10), stack(FUNDUS, seed=11)
    assert batch.chunks(first.shape) == ((0, 2), (2, 3))
    tracing.enable()
    kernels.reset_launches()
    try:
        got = batch.process_batch(first, cols)
        snap = tracing.snapshot()
    finally:
        tracing.disable()
    assert kernels.LAUNCHES == {"bake_u8": 2, kernel: 2, "crop_u8": 2}
    assert snap.counters["batch_chunks"] == 2
    assert snap.spans["fetch"][0] == 1
    assert torch.from_numpy(got).is_pinned()
    expected = [[want(im) for im in s] for s in (first, second)]
    for i in range(3):
        np.testing.assert_array_equal(got[i], expected[0][i])
    # Two stacks in flight at once: each chunk's card output lives until
    # the copy stream has read it.
    tokens = [batch._dispatch_batch(s, cols, torch.device("cuda"))
              for s in (first, second)]
    for token, want_stack in zip(tokens, expected):
        out = batch._fetch_batch(token)
        for i in range(3):
            np.testing.assert_array_equal(out[i], want_stack[i])
