"""The port's row sharding (dip_benchmark_tpu_torch/parallel) against the
JAX package's parallel/ on the conftest's 8 virtual CPU devices, and
against the port's own unsharded ops.

The port's shards are CPU tensors here, so every op runs its plain
PyTorch version; the JAX ops run under shard_map (the Pallas ones in
interpret mode). Both get the same seeded numpy inputs; resident arrays
cross over through from_jax_resident. Tolerance 0 in uint8, and on the
float32 kernel path against the port's unsharded ops (the same plain
versions compute every pixel in the same order); within 3e-7 (2 ulp at 1,
tests/test_f32_path.py) against JAX's float32, which may contract a
multiply-add into an FMA.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from dip_benchmark_tpu.parallel import halo as jax_halo
from dip_benchmark_tpu.parallel import pallas_ops as jax_pallas_ops
from dip_benchmark_tpu.utils import image as jax_image
from dip_benchmark_tpu_torch import oracle
from dip_benchmark_tpu_torch.models import chain
from dip_benchmark_tpu_torch.ops import OPS, OPS_F32, kernels
from dip_benchmark_tpu_torch.parallel import (exchange_row_halo, make_mesh,
                                              refresh_resident_cols,
                                              refresh_resident_halo,
                                              sharded_fused_pipeline,
                                              sharded_op)
from dip_benchmark_tpu_torch.parallel.kernel_ops import (
    POINT_COLS, build_sharded_kernel_ops, refresh, sharded_kernel_chain,
    sharded_kernel_pipeline)
from dip_benchmark_tpu_torch.parallel.ops import _erode_local
from dip_benchmark_tpu_torch.utils.image import (
    from_jax_resident, from_resident_planar, make_layout, mirror_cols,
    mirror_rows, to_planar_padded, to_resident_planar)

NS = (1, 2, 3, 4, 8)
ATOL_F32 = 3e-7
ROWS = P(None, "space", None)
CHAINS = {
    "C1": ["Convolution-5x5", "Inversion", "Convolution-3x3"],
    "C2": ["Grayscale", "Threshold", "Erosion-3x3-Square",
           "Gaussian-Blur-3x3"],
    "C3": ["Convolution-1x5+5x1", "Erosion-3x3-Cross"],
    "C4": ["Convolution-5x5"] * 4,
    "R4": ["Convolution-5x5", "Convolution-5x5"],
}
WINDOWED = sorted(c for c in OPS if c not in POINT_COLS)


def image(hw, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, hw + (3,), np.uint8)


def planar_of(img) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(img, (2, 0, 1)))


def cpu_mesh(n_space, n_data=1):
    return make_mesh(n_space, n_data, backend="cpu")


def jax_mesh(n_space, n_data=1):
    return jax_halo.make_mesh(n_space=n_space, n_data=n_data)


def jax_rows(fn, mesh):
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=ROWS,
                                 out_specs=ROWS, check_vma=False))


# -- the resident layout ---------------------------------------------------

@pytest.mark.parametrize("pad", [2, 3, 4])
@pytest.mark.parametrize("n", NS)
def test_resident_blocks_are_windows_of_the_bake(n, pad):
    # Block i is rows [i * h_loc, i * h_loc + Hp) of the unsharded bake
    # with the same pad, and the valid rows come back whole.
    img = image((48, 37), seed=n)
    layout = make_layout(48 // n, 37, pad=pad)
    blocks = to_resident_planar(planar_of(img), layout, n)
    whole = to_planar_padded(img, make_layout(48, 37, pad=pad))
    assert len(blocks) == n
    for i, b in enumerate(blocks):
        assert b.shape == layout.shape and b.is_contiguous()
        assert torch.equal(b, whole[:, i * layout.height:
                                    i * layout.height + layout.padded_height])
    np.testing.assert_array_equal(
        from_resident_planar(blocks, layout, 48 // n), planar_of(img))
    np.testing.assert_array_equal(
        from_resident_planar(blocks, layout, 48 // n, height=41),
        planar_of(img)[:, :41])


@pytest.mark.parametrize("pad", [2, 3, 4])
@pytest.mark.parametrize("n", NS)
def test_resident_blocks_agree_with_jax(n, pad):
    img = image((48, 37), seed=10 + n)
    jax_layout = jax_image.make_layout(48 // n, 37, halo=pad)
    jax_res = jax_image.to_resident_planar(planar_of(img), jax_layout, n)
    blocks = to_resident_planar(planar_of(img),
                                make_layout(48 // n, 37, pad=pad), n)
    got = from_jax_resident(jax_res, jax_layout, n, pad)
    assert all(torch.equal(a, b) for a, b in zip(got, blocks))
    np.testing.assert_array_equal(
        from_resident_planar(blocks, make_layout(48 // n, 37, pad=pad),
                             48 // n, height=45),
        jax_image.from_resident_planar(jax_res, jax_layout, n, 48 // n,
                                       height=45))


def test_resident_stack_and_float32_pass_through():
    stack = np.stack([planar_of(image((24, 20), seed=s)) for s in (1, 2)])
    f32 = stack.astype(np.float32) / np.float32(255)
    layout = make_layout(6, 20)
    for arr in (stack, f32):
        blocks = to_resident_planar(arr, layout, 4)
        assert blocks[0].shape == (2,) + layout.shape
        assert blocks[0].dtype == torch.from_numpy(arr).dtype
        np.testing.assert_array_equal(
            from_resident_planar(blocks, layout, 6), arr)


def test_resident_refuses_a_mismatch():
    planar = planar_of(image((24, 20)))
    with pytest.raises(ValueError, match="divide"):
        to_resident_planar(planar, make_layout(5, 20), 5)
    with pytest.raises(ValueError, match="per-shard"):
        to_resident_planar(planar, make_layout(8, 20), 4)
    blocks = to_resident_planar(planar, make_layout(6, 20), 4)
    with pytest.raises(ValueError, match="h_loc"):
        from_resident_planar(blocks, make_layout(6, 20), 5)


# -- the halo exchange and the refreshes -----------------------------------

@pytest.mark.parametrize("halo", [1, 2])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_exchange_row_halo_matches_jax(n, halo, gradient_image):
    planar = planar_of(gradient_image)  # (3, 24, 40): 3 rows a shard at 8
    h_loc = 24 // n
    want = np.asarray(jax_rows(lambda s: jax_halo.exchange_row_halo(
        s, halo), jax_mesh(n))(planar))
    blocks = [torch.from_numpy(planar[:, i * h_loc:(i + 1) * h_loc])
              for i in range(n)]
    got = exchange_row_halo(blocks, halo)
    ext = h_loc + 2 * halo
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g.numpy(), want[:, i * ext:(i + 1) * ext],
                                      err_msg=f"shard {i}")


@pytest.mark.parametrize("n", NS)
def test_refresh_matches_jax_and_restores_the_bake(n):
    # Garbage in every halo row and column; both packages refresh; they
    # agree on the JAX layout's window, and the port's blocks equal its
    # bake again, the pitch's slack included.
    h, w, pad = 48, 37, 2
    img = image((h, w), seed=20 + n)
    jax_layout = jax_image.make_layout(h // n, w)
    jax_res = jax_image.to_resident_planar(planar_of(img), jax_layout, n)
    rng = np.random.default_rng(n)
    hp, h_loc = jax_layout.padded_height, h // n
    py, px = jax_layout.pad_y, jax_layout.pad_x
    valid = np.zeros(jax_res.shape, bool)
    for i in range(n):
        valid[:, i * hp + py:i * hp + py + h_loc, px:px + w] = True
    jax_res = np.where(valid, jax_res,
                       rng.integers(0, 256, jax_res.shape, np.uint8))
    layout = make_layout(h_loc, w, pad=pad)
    blocks = from_jax_resident(jax_res, jax_layout, n, pad)

    jax_out = np.asarray(jax_rows(lambda b: jax_halo.refresh_resident_cols(
        jax_halo.refresh_resident_halo(b, py, h_loc), px, w),
        jax_mesh(n))(jax_res))
    assert refresh_resident_halo(blocks, pad, h_loc) is blocks
    for b in blocks:
        assert refresh_resident_cols(b, pad, w) is b
    want = from_jax_resident(jax_out, jax_layout, n, pad)
    for i, (g, j) in enumerate(zip(blocks, want)):
        assert torch.equal(g[..., :w + 2 * pad], j[..., :w + 2 * pad]), i
    baked = to_resident_planar(planar_of(img), layout, n)
    assert all(torch.equal(g, b) for g, b in zip(blocks, baked))


def test_refresh_cols_is_rank_generic():
    layout = make_layout(6, 20, pad=3)
    stack = np.stack([planar_of(image((24, 20), seed=s)) for s in (3, 4)])
    baked = to_resident_planar(stack, layout, 4)
    for b in baked:
        scrambled = b.clone()
        scrambled[..., :3] = 201
        scrambled[..., 23:] = 202
        refresh_resident_cols(scrambled, 3, 20)
        assert torch.equal(scrambled, b)


def test_sharded_op_matches_jax_sharded_op(gradient_image):
    planar = planar_of(gradient_image)

    def jax_local(xp):  # (C, h + 2, W) -> (C, h, W): the JAX test's body
        import jax.numpy as jnp
        from dip_benchmark_tpu.ops import xla
        hwc = jnp.transpose(xp, (1, 2, 0))
        padded = xla.mirror_pad(hwc, 0, 1)
        out = jax.lax.reduce_window(padded, np.uint8(255), jax.lax.min,
                                    (3, 3, 1), (1, 1, 1), "VALID")
        return jnp.transpose(out, (2, 0, 1))

    want = np.asarray(jax_halo.sharded_op(jax_local, jax_mesh(8), 1)(planar))
    op = sharded_op(lambda xp: _erode_local(xp, 3, 3), cpu_mesh(8), 1)
    got = op(tuple(torch.from_numpy(planar[:, 3 * i:3 * i + 3])
                   for i in range(8)))
    np.testing.assert_array_equal(torch.cat(got, dim=1).numpy(), want)
    np.testing.assert_array_equal(
        want, planar_of(oracle.erosion(gradient_image,
                                       oracle.spec.SQUARE_MASK_3X3)))


@pytest.mark.parametrize("n_space,n_data", [(4, 2), (2, 2), (1, 3)])
def test_sharded_fused_pipeline_matches_jax(n_space, n_data):
    rng = np.random.default_rng(n_space)
    batch = rng.integers(0, 256, (6, 3, 24, 44), np.uint8)
    want = np.asarray(jax_halo.sharded_fused_pipeline(
        jax_mesh(n_space, n_data))(batch))
    got = sharded_fused_pipeline(cpu_mesh(n_space, n_data))(batch)
    np.testing.assert_array_equal(got.numpy(), want)
    for b in range(6):
        np.testing.assert_array_equal(
            want[b], planar_of(oracle.fused_pipeline(
                np.ascontiguousarray(np.transpose(batch[b], (1, 2, 0))))))


# -- the kernels on resident blocks ----------------------------------------

def unsharded(col, planar, dtype, k):
    """``k`` applications of the unsharded op to a ``(C, H, W)`` planar,
    each on a fresh bake of the last one's valid region."""
    c, h, w = planar.shape
    layout = make_layout(h, w)
    ys, xs = mirror_rows(layout), mirror_cols(layout)
    ops = OPS_F32 if dtype == "float32" else OPS
    for _ in range(k):
        out = ops[col](torch.from_numpy(np.ascontiguousarray(
            planar[:, ys[:, None], xs[None, :]])))
        planar = out[:, 2:2 + h, 2:2 + w].numpy()
    return planar


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("col", WINDOWED)
def test_sharded_applications_compose(col, dtype):
    # K = 1..5 chained sharded applications equal K unsharded ones that
    # each re-bake their input: the refresh renews both axes' halos, which
    # the kernels' zero ring leaves stale.
    planar = planar_of(image((40, 37), seed=7))
    if dtype == "float32":
        planar = planar.astype(np.float32) / np.float32(255)
    mesh = cpu_mesh(4)
    ops, layout = build_sharded_kernel_ops(mesh, 40, 37, dtype)
    blocks = to_resident_planar(planar, layout, 4)
    for k in range(1, 6):
        blocks = ops[col](blocks)
        np.testing.assert_array_equal(
            from_resident_planar(blocks, layout, 10),
            unsharded(col, planar, dtype, k), err_msg=f"{col} x{k}")


def jax_chain_crop(cols, planar, n, batch=0, n_data=1, dtype="uint8"):
    """JAX's sharded_pallas_chain (interpret mode) on ``planar``, its
    valid crop."""
    h, w = planar.shape[-2:]
    mesh = jax_mesh(n, n_data)
    fn, layout = jax_pallas_ops.sharded_pallas_chain(
        mesh, cols, h, w, batch=batch, dtype=dtype)
    spec_ = P("data", None, "space", None) if batch else ROWS
    x = jax.device_put(jax_image.to_resident_planar(planar, layout, n),
                       NamedSharding(mesh, spec_))
    return jax_image.from_resident_planar(np.asarray(fn(x)), layout, n,
                                          h // n, h)


def planar_model(img, dtype):
    planar = planar_of(img) if img.ndim == 3 else np.ascontiguousarray(
        np.transpose(img, (0, 3, 1, 2)))
    if dtype == "float32":
        return planar.astype(np.float32) / np.float32(255)
    return planar


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("name", sorted(CHAINS))
def test_sharded_chain_equals_unsharded_and_oracle(name, n, dtype):
    cols = CHAINS[name]
    img = image((72, 44), seed=30 + n)  # 9 rows a shard at 8: C4's radius
    planar = planar_model(img, dtype)
    kernels.reset_launches()
    op, layout = sharded_kernel_chain(cpu_mesh(n), cols, 72, 44, dtype=dtype)
    assert layout.pad == max(2, *chain.check_chain(cols))
    got = from_resident_planar(op(to_resident_planar(planar, layout, n)),
                               layout, 72 // n)
    whole = make_layout(72, 44, pad=layout.pad)
    make = (chain.make_fused_chain_f32 if dtype == "float32"
            else chain.make_fused_chain)
    want = from_resident_planar(
        (make(whole, cols)(to_resident_planar(planar, whole, 1)[0]),),
        whole, 72)
    np.testing.assert_array_equal(got, want)
    assert kernels.LAUNCHES == {}  # CPU shards: the plain versions
    seq = chain.chain_row_parts(cols, dtype)[2](img)
    if dtype == "uint8":
        np.testing.assert_array_equal(np.transpose(got, (1, 2, 0)), seq)
    else:
        expected, dontcare = seq if isinstance(seq, tuple) else (seq, False)
        u8 = np.clip(np.rint(got * np.float32(255)), 0, 255).astype(np.uint8)
        delta = np.abs(np.transpose(u8, (1, 2, 0)).astype(int)
                       - expected.astype(int))
        assert np.where(dontcare, 0, delta).max() <= 1


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("name", sorted(CHAINS))
def test_sharded_chain_matches_jax(name, dtype):
    cols = CHAINS[name]
    planar = planar_model(image((72, 44), seed=40), dtype)
    op, layout = sharded_kernel_chain(cpu_mesh(8), cols, 72, 44, dtype=dtype)
    got = from_resident_planar(op(to_resident_planar(planar, layout, 8)),
                               layout, 9)
    want = jax_chain_crop(cols, planar, 8, dtype=dtype)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ATOL_F32 if dtype == "float32" else 0)


@pytest.mark.parametrize("name", ["C2", "C3"])
def test_batched_chain_on_a_2d_mesh_matches_jax(name):
    cols = CHAINS[name]
    stack = np.random.default_rng(12).integers(0, 256, (4, 32, 40, 3),
                                               np.uint8)
    planar = planar_model(stack, "uint8")
    mesh = cpu_mesh(4, 2)
    op, layout = sharded_kernel_chain(mesh, cols, 32, 40, batch=4)
    resident = to_resident_planar(planar, layout, 4)
    blocks = tuple(resident[s][2 * d:2 * d + 2] for d in range(2)
                   for s in range(4))
    out = mesh.rows(op(blocks))
    got = np.concatenate([from_resident_planar(row, layout, 8)
                          for row in out])
    np.testing.assert_array_equal(
        got, jax_chain_crop(cols, planar, 4, batch=4, n_data=2))
    seq = chain.chain_row_parts(cols)[2]
    for b in range(4):
        np.testing.assert_array_equal(np.transpose(got[b], (1, 2, 0)),
                                      seq(stack[b]))


def test_pipeline_on_a_2d_mesh_matches_jax():
    stack = np.random.default_rng(9).integers(0, 256, (4, 24, 52, 3),
                                              np.uint8)
    planar = planar_model(stack, "uint8")
    mesh = cpu_mesh(4, 2)
    op, layout = sharded_kernel_pipeline(mesh, 4, 24, 52)
    resident = to_resident_planar(planar, layout, 4)
    out = op(tuple(resident[s][2 * d:2 * d + 2] for d in range(2)
                   for s in range(4)))
    got = np.concatenate([from_resident_planar(row, layout, 6)
                          for row in mesh.rows(out)])
    jm = jax_mesh(4, 2)
    fn, jl = jax_pallas_ops.sharded_pallas_pipeline(jm, 4, 24, 52)
    x = jax.device_put(jax_image.to_resident_planar(planar, jl, 4),
                       NamedSharding(jm, P("data", None, "space", None)))
    want = jax_image.from_resident_planar(np.asarray(fn(x)), jl, 4, 6, 24)
    np.testing.assert_array_equal(got, want)
    for b in range(4):
        np.testing.assert_array_equal(np.transpose(got[b], (1, 2, 0)),
                                      oracle.fused_pipeline(stack[b]))


@pytest.mark.parametrize("case", ["chain", "ops", "batch"])
def test_thin_shard_refusals_match_jax(case):
    def port():
        if case == "chain":
            sharded_kernel_chain(cpu_mesh(8), CHAINS["R4"], 32, 44)
        elif case == "ops":
            build_sharded_kernel_ops(cpu_mesh(8), 16, 44)
        else:
            sharded_kernel_chain(cpu_mesh(2, 2), CHAINS["C1"], 32, 44,
                                 batch=3)

    def jax_():
        if case == "chain":
            jax_pallas_ops.sharded_pallas_chain(jax_mesh(8), CHAINS["R4"],
                                                32, 44)
        elif case == "ops":
            jax_pallas_ops.build_sharded_pallas_ops(jax_mesh(8), 16, 44)
        else:
            jax_pallas_ops.sharded_pallas_chain(jax_mesh(2, 2), CHAINS["C1"],
                                                32, 44, batch=3)

    with pytest.raises(ValueError) as ours:
        port()
    with pytest.raises((ValueError, AssertionError)) as theirs:
        jax_()
    assert str(ours.value) == str(theirs.value)
