"""The port's sharded session, CLI --shards and the batch tool's
--shards/--data-shards against the port's unsharded session and the JAX
package's ShardedBenchmarkSession, CLI and batch tool, on the CPU.

Every op of both data models and both paths at n = 1, 2, 3, 4 and 8
shards, on the conftest's 37x53 image (its rows padded to shard for n >
1) and its 24x40 gradient at 8 shards of 3 rows. The "kernel" path is
held to JAX's "pallas" session (interpret mode) at n = 1, 2 and 8, and to
its "xla" session at n = 3 and 4, where a Pallas session's interpret-mode
compiles (about 2.5 s a session here) would only repeat n = 1, 2 and 8;
the "library" path to JAX's "xla". Held to:
- the unsharded port session: tolerance 0 in uint8 and on the float32
  kernel path (the same plain versions compute every pixel in the same
  order); on the float32 library path the uint8 crops within 1 level
  outside the oracle's don't-care mask (the sharded correlation sums in
  the JAX order, the unsharded one is F.conv2d);
- JAX's sharded session at the same n: tolerance 0 in uint8; in float32
  the values before quantization within 3e-7 (2 ulp at 1,
  tests/test_f32_path.py: XLA may contract a multiply-add into an FMA).
"""

import numpy as np
import pytest
import torch

from dip_benchmark_tpu import cli as jax_cli
from dip_benchmark_tpu.models import batch as jax_batch
from dip_benchmark_tpu.parallel.session import (
    ShardedBenchmarkSession as JaxShardedSession)
from dip_benchmark_tpu.utils import image as jax_image
from dip_benchmark_tpu_torch import cli, oracle
from dip_benchmark_tpu_torch.models import batch, chain
from dip_benchmark_tpu_torch.ops import kernels
from dip_benchmark_tpu_torch.parallel import Mesh
from dip_benchmark_tpu_torch.parallel import session as port_session
from dip_benchmark_tpu_torch.parallel.session import ShardedBenchmarkSession
from dip_benchmark_tpu_torch.session import BenchmarkSession
from dip_benchmark_tpu_torch.utils.image import (from_resident_planar,
                                                 load_image, save_image)

CPU = torch.device("cpu")
JAX_PATH = {"kernel": "pallas", "library": "xla"}
XLA_ONLY = (3, 4)  # the shard counts at which "kernel" meets JAX's "xla"
ATOL_F32 = 3e-7
C1 = ["Convolution-5x5", "Inversion", "Convolution-3x3"]
C2 = ["Grayscale", "Threshold", "Erosion-3x3-Square", "Gaussian-Blur-3x3"]
C3 = ["Convolution-1x5+5x1", "Erosion-3x3-Cross"]
C4 = ["Convolution-5x5"] * 4
CASES = [(fixture, n) for n in (1, 2, 3, 4, 8)
         for fixture in ["small_image"]] + [("gradient_image", 8)]


def raw(session) -> np.ndarray:
    """The port session's last output: its valid ``(C, H, W)`` values."""
    if isinstance(session, ShardedBenchmarkSession):
        if session.layout is None:
            return torch.cat(session._sample, dim=1)[
                :, :session.valid_height].numpy()
        return from_resident_planar(session._sample, session.layout,
                                    session.h_loc, session.valid_height)
    h, w = session.host_image.shape[:2]
    if session.path == "library":
        return session._sample.cpu().numpy()
    p = session.layout.pad
    return session._sample[:, p:p + h, p:p + w].cpu().numpy()


def jax_raw(session) -> np.ndarray:
    if session.layout is None:
        return np.asarray(session._sample)[:, :session.valid_height]
    return jax_image.from_resident_planar(
        np.asarray(session._sample), session.layout, session.n_shards,
        session.h_loc, height=session.valid_height)


def rows_of(session, include_pipeline=True) -> dict:
    return {op.csv_column: op for op in
            session.operations(include_pipeline=include_pipeline)
            if op.prefix}


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("path", ["kernel", "library"])
@pytest.mark.parametrize("fixture,n", CASES)
def test_sharded_matrix_equals_unsharded_and_jax(fixture, n, path, dtype,
                                                 request):
    img = request.getfixturevalue(fixture)
    sharded = ShardedBenchmarkSession(img, CPU, n_devices=n, path=path,
                                      dtype=dtype)
    whole = BenchmarkSession(img, CPU, dtype=dtype, path=path)
    theirs = JaxShardedSession(
        img, n_devices=n, dtype=dtype,
        path="xla" if n in XLA_ONLY else JAX_PATH[path])
    assert sharded.host_planar.shape == theirs.host_planar.shape
    assert sharded.h_loc == theirs.h_loc and len(sharded.blocks) == n
    oracles = whole.oracle_ops()
    mine, ref, jax_ops = rows_of(sharded), rows_of(whole), rows_of(theirs)
    assert sorted(mine) == sorted(ref) == sorted(jax_ops)
    for col, op in mine.items():
        op.run()
        got, got_raw = op.fetch(), raw(sharded)
        ref[col].run()
        jax_ops[col].run()
        if dtype == "uint8":
            np.testing.assert_array_equal(got, ref[col].fetch(), err_msg=col)
            np.testing.assert_array_equal(got, jax_ops[col].fetch(),
                                          err_msg=col)
            continue
        np.testing.assert_allclose(got_raw, jax_raw(theirs), rtol=0,
                                   atol=ATOL_F32, err_msg=col)
        if path == "kernel":
            np.testing.assert_array_equal(got_raw, raw(whole), err_msg=col)
        else:
            want = oracles[col](img)
            dontcare = want[1] if isinstance(want, tuple) else False
            delta = np.abs(got.astype(int) - ref[col].fetch().astype(int))
            assert np.where(dontcare, 0, delta).max() <= 1, col


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("path", ["kernel", "library"])
def test_upload_and_download_move_the_unpadded_rows(path, dtype,
                                                    small_image):
    session = ShardedBenchmarkSession(small_image, CPU, n_devices=4,
                                      path=path, dtype=dtype)
    theirs = JaxShardedSession(small_image, n_devices=4,
                               path=JAX_PATH[path], dtype=dtype)
    up = session._upload()
    assert [tuple(b.shape) for b in up] == [(3, 10, 53)] * 4
    np.testing.assert_array_equal(torch.cat(up, dim=1).numpy(),
                                  session.host_planar)
    down = session._download()
    theirs._download_prepare()
    np.testing.assert_array_equal(
        down, np.asarray(theirs._download())[:, :37])
    np.testing.assert_array_equal(down, session.host_planar[:, :37])


@pytest.mark.parametrize("hw,n", [((5, 20), 4), ((11, 14), 8),
                                  ((24, 4), 2)])
def test_session_refusals_match_jax(hw, n):
    img = np.zeros(hw + (3,), np.uint8)
    with pytest.raises(ValueError) as ours:
        ShardedBenchmarkSession(img, CPU, n_devices=n)
    with pytest.raises(ValueError) as theirs:
        JaxShardedSession(img, n_devices=n)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("n", [2, 8])
def test_chain_rows_pad_for_the_chain_and_match_jax(n, dtype, small_image):
    session = ShardedBenchmarkSession(small_image, CPU, n_devices=n,
                                      dtype=dtype)
    theirs = JaxShardedSession(small_image, n_devices=n, path="pallas",
                               dtype=dtype)
    for cols in (C1, C2, C3, C4):
        op = session.chain_operation(cols)
        op.run()
        jax_op = theirs.chain_operation(cols)
        jax_op.run()
        got = op.fetch()
        expected = session.oracle_ops()[op.csv_column](small_image)
        if dtype == "uint8":
            np.testing.assert_array_equal(got, expected, err_msg=str(cols))
            np.testing.assert_array_equal(got, jax_op.fetch(),
                                          err_msg=str(cols))
        else:
            want, dontcare = (expected if isinstance(expected, tuple)
                              else (expected, False))
            delta = np.abs(got.astype(int) - want.astype(int))
            assert np.where(dontcare, 0, delta).max() <= 1, cols
    assert sum(k.startswith("Fused-Chain(")
               for k in session.oracle_ops()) == 4


def test_chain_refusals(small_image):
    img = small_image[:12, :20]
    with pytest.raises(ValueError) as ours:
        ShardedBenchmarkSession(img, CPU, n_devices=4).chain_operation(C4)
    with pytest.raises(ValueError) as theirs:
        JaxShardedSession(img, n_devices=4,
                          path="pallas").chain_operation(C4)
    assert str(ours.value) == str(theirs.value)
    assert "too small" in str(ours.value)
    library = ShardedBenchmarkSession(small_image, CPU, n_devices=2,
                                      path="library")
    with pytest.raises(ValueError, match="needs --path kernel"):
        library.chain_operation(C1)


@pytest.mark.parametrize("path", ["kernel", "library"])
def test_execution_table_over_the_mesh(path, small_image):
    session = ShardedBenchmarkSession(small_image, CPU, n_devices=4,
                                      path=path)
    if path == "kernel":
        session.chain_operation(C3)
    rows = session.execution_table(include_pipeline=True, ks=(1, 2, 3),
                                   samples=1)
    cols = [c for c, _ in rows]
    assert cols[:13] == list(oracle.IMAGE_OPS)
    assert cols[13:] == (["Fused-Chain"] if path == "kernel" else [])
    assert all(t.where == "host" and np.isfinite(t.per_app_s)
               for _, t in rows)


def two_device_mesh(n, n_data=1, backend="cuda"):
    # Shards on two "devices": the CPU under two indices.
    return Mesh((tuple(torch.device("cpu", i % 2) for i in range(n)),))


def test_exec_is_refused_on_a_mesh_over_several_devices(small_image,
                                                        tmp_path,
                                                        monkeypatch, capsys):
    session = ShardedBenchmarkSession(small_image, CPU,
                                      mesh=two_device_mesh(2))
    with pytest.raises(ValueError, match="one device"):
        session.execution_table()
    with pytest.raises(ValueError, match="--chained"):
        session.chained_operations(2)
    monkeypatch.setattr(port_session, "make_mesh", two_device_mesh)
    path = str(tmp_path / "img.png")
    save_image(path, small_image)
    assert cli.main([path, str(tmp_path / "out"), "--rounds", "1",
                     "--backend", "cpu", "--shards", "2", "--exec"]) == 2
    assert "one device" in capsys.readouterr().err


# -- the CLI ---------------------------------------------------------------

def table_rows(text: str) -> list[str]:
    return [ln for ln in text.splitlines()
            if ln.startswith("| ") and "(once)" in ln]


@pytest.mark.parametrize("dtype,fuse", [("uint8", C1), ("float32", C2)])
def test_cli_shards_verify_pipeline_fuse(dtype, fuse, tmp_path, small_image,
                                         capsys):
    path = str(tmp_path / "img.png")
    save_image(path, small_image)
    csv = tmp_path / "r.csv"
    assert cli.main([path, str(tmp_path / "out"), "--rounds", "2",
                     "--backend", "cpu", "--shards", "4", "--verify",
                     "--pipeline", "--fuse", ",".join(fuse), "--dtype",
                     dtype, "--csv", str(csv)]) == 0
    assert len(table_rows(capsys.readouterr().out)) == 16
    assert len(list((tmp_path / "out").iterdir())) == 14
    # The tool name does not change with shards, as in the JAX CLI.
    assert csv.read_text().splitlines()[1].startswith("CPU-torch,")


def test_cli_shards_exec_prints_13_rows(tmp_path, small_image, capsys):
    path = str(tmp_path / "img.png")
    save_image(path, small_image)
    assert cli.main([path, str(tmp_path / "out"), "--rounds", "1",
                     "--backend", "cpu", "--shards", "4", "--pipeline",
                     "--exec"]) == 0
    lines = capsys.readouterr().out.splitlines()
    head = next(i for i, ln in enumerate(lines) if "execution time" in ln)
    assert [ln.split("|")[1].strip() for ln in lines[head + 1:]] == list(
        oracle.IMAGE_OPS)


CLI_CASES = {
    "negative": (["--shards", "-1"], 2),
    "chained": (["--shards", "2", "--chained", "2"], 2),
    "too-many": (["--shards", "8"], 2),
    "library-fuse": (["--shards", "2", "--path", "library", "--fuse",
                      "Inversion,Copy"], 2),
    "library-verify": (["--shards", "3", "--path", "library", "--verify",
                        "--pipeline"], 0),
    "warm": (["--shards", "2", "--warm", "--verify"], 0),
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_exits_like_the_jax_cli(case, tmp_path, capsys):
    args, code = CLI_CASES[case]
    path = str(tmp_path / "img.png")
    save_image(path, np.random.default_rng(3).integers(0, 256, (11, 14, 3),
                                                       np.uint8))
    codes = {}
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        argv = args if name == "port" else [JAX_PATH.get(a, a) for a in args]
        codes[name] = main([path, str(tmp_path / f"out-{name}"), "--rounds",
                            "1", "--warmup", "0", "--backend", "cpu", *argv])
    capsys.readouterr()
    assert codes == {"port": code, "jax": code}


# -- the batch tool ---------------------------------------------------------

def write_dir(path, images: dict) -> None:
    path.mkdir()
    for name, img in images.items():
        save_image(str(path / name), img)


@pytest.mark.parametrize("op", ["Fused-Pipeline", ",".join(C3)])
def test_batch_tool_on_a_2x2_mesh(op, tmp_path, capsys):
    rng = np.random.default_rng(5)
    imgs = {f"im{i}.png": rng.integers(0, 256, (21, 30, 3), np.uint8)
            for i in range(3)}
    imgs["odd.png"] = rng.integers(0, 256, (14, 9, 3), np.uint8)
    write_dir(tmp_path / "in", imgs)
    flags = ["--shards", "2", "--data-shards", "2", "--batch-size", "3",
             "--op", op, "--backend", "cpu"]
    kernels.reset_launches()
    assert batch.main([str(tmp_path / "in"), str(tmp_path / "port"),
                       *flags]) == 0
    assert kernels.LAUNCHES == {}
    assert jax_batch.main([str(tmp_path / "in"), str(tmp_path / "jax"),
                           *flags]) == 0
    capsys.readouterr()
    expect = (oracle.fused_pipeline if op == "Fused-Pipeline"
              else chain.chain_row_parts(op.split(","))[2])
    for name, img in imgs.items():
        got = load_image(str(tmp_path / "port" / name))
        np.testing.assert_array_equal(got, expect(img), err_msg=name)
        np.testing.assert_array_equal(
            got, load_image(str(tmp_path / "jax" / name)), err_msg=name)


@pytest.mark.parametrize("n_space,n_data", [(3, 1), (2, 3), (4, 2)])
def test_process_batch_pads_rows_and_the_batch(n_space, n_data):
    from dip_benchmark_tpu_torch.parallel import make_mesh
    imgs = np.random.default_rng(n_space).integers(0, 256, (3, 37, 53, 3),
                                                   np.uint8)
    mesh = make_mesh(n_space, n_data, backend="cpu")
    got = batch.process_batch(imgs, C1, mesh=mesh)
    seq = chain.chain_row_parts(C1)[2]
    assert got.shape == imgs.shape
    for b in range(3):
        np.testing.assert_array_equal(got[b], seq(imgs[b]))
    with pytest.raises(ValueError, match="chain/pipeline ops only"):
        batch.process_batch(imgs, "Grayscale", mesh=mesh)


@pytest.mark.parametrize("args, says", [
    (["--shards", "-1"], "--shards needs N >= 0"),
    (["--shards", "2", "--data-shards", "0"], "--data-shards D >= 1"),
    (["--shards", "2", "--op", "Convolution-5x5"], "chain/pipeline ops only"),
])
def test_batch_tool_refuses_with_exit_2(args, says, tmp_path, capsys):
    (tmp_path / "in").mkdir()
    assert batch.main([str(tmp_path / "in"), str(tmp_path / "out"), *args,
                       "--backend", "cpu"]) == 2
    assert says in capsys.readouterr().err
    assert not (tmp_path / "out").exists()


# -- on the card -------------------------------------------------------------

def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("n", [2, 3, 8])
def test_sharded_kernels_on_card_equal_the_unsharded(n, dtype, small_image):
    # One launch a shard, and the valid values equal to the unsharded
    # session's, tolerance 0; the thinnest shards (5 rows at 8) included.
    dev = card()
    sharded = ShardedBenchmarkSession(small_image, dev, n_devices=n,
                                      dtype=dtype)
    whole = BenchmarkSession(small_image, dev, dtype=dtype)
    mine, ref = rows_of(sharded), rows_of(whole)
    for col, op in mine.items():
        kernels.reset_launches()
        op.run()
        assert list(kernels.LAUNCHES.values()) == [n], col
        ref[col].run()
        np.testing.assert_array_equal(raw(sharded), raw(whole), err_msg=col)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["kernel", "library"])
def test_sharded_graph_replay_equals_direct_calls(path, small_image):
    from dip_benchmark_tpu_torch.runtime import exec_timing
    session = ShardedBenchmarkSession(small_image, card(), n_devices=4,
                                      path=path)
    src = session._device_input()
    graphs = exec_timing.GraphCache()
    for col, fn in session._ops.items():
        fn(src)
        for k in (1, 3):
            want = exec_timing.chain_direct(fn, src, k)
            assert exec_timing.same(graphs.replay(col, fn, src, k), want), col
