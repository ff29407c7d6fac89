"""Row-block streaming (``models/wide.apply_streaming``) against the JAX
package's ``wide.apply_streaming`` and the port's whole-image ops, the
block bake against JAX's ``to_wide_resident``, and the CUDA session's
refusal of a buffer past the card's free memory.

The JAX function runs as ``tests/test_wide.py`` runs it, Pallas in
interpret mode on the CPU, its strips one lane wide (``strip_width=LANE``)
so that a 200-column image crosses a seam; the port's blocks run each op's
plain PyTorch version on CPU tensors. uint8 is held to ``array_equal``
here; the float32 model is in ``tests/test_torch_streaming_f32.py``. The
card-only tests at the end run every launcher on a raw planar taller than
its old ``gridDim.y`` cap and skip without a CUDA device; where JAX is not
installed they alone run (``python -m pytest --noconftest
tests/test_torch_streaming.py -m cuda``).
"""

import numpy as np
import pytest
import torch

from dip_benchmark_tpu_torch import session as session_mod
from dip_benchmark_tpu_torch.models import wide
from dip_benchmark_tpu_torch.ops import OPS, OPS_F32
from dip_benchmark_tpu_torch.runtime import DeviceGateError
from dip_benchmark_tpu_torch.session import BenchmarkSession, check_fits
from dip_benchmark_tpu_torch.utils.image import (crop_planar,
                                                 from_jax_planar,
                                                 from_planar_padded,
                                                 make_layout,
                                                 to_planar_padded,
                                                 to_planar_padded_f32)

try:
    from dip_benchmark_tpu.models import wide as jax_wide
    from dip_benchmark_tpu.utils.image import LANE
except ImportError:   # a machine with a card and no JAX runs the card tests
    jax_wide = LANE = None

CPU = torch.device("cpu")
SHAPE = (40, 200)   # blocks of 16: 16, 16 and 8 rows
BLOCK_ROWS = 16


@pytest.fixture(autouse=True)
def _needs_jax(request):
    if jax_wide is None and request.node.get_closest_marker("cuda") is None:
        pytest.skip("compares with the JAX package, which is not installed")


def image(h: int, w: int, seed: int = 13) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


def whole(img: np.ndarray, col: str, dtype: str) -> np.ndarray:
    """The port's whole-image op in apply_streaming's output form."""
    layout = make_layout(*img.shape[:2])
    if dtype == "uint8":
        return from_planar_padded(OPS[col](to_planar_padded(img, layout)),
                                  layout)
    return crop_planar(OPS_F32[col](to_planar_padded_f32(img, layout)),
                       layout)


def test_columns_are_the_jax_packages():
    assert wide.WIDE_COLS == jax_wide.WIDE_COLS
    assert wide.WINDOWED_COLS == jax_wide.WINDOWED_COLS
    assert len(wide.WIDE_COLS) == 13


@pytest.mark.parametrize("col", wide.WIDE_COLS)
def test_uint8_equals_jax_apply_streaming(col):
    img = image(*SHAPE)
    got = wide.apply_streaming(img, col, block_rows=BLOCK_ROWS, device=CPU)
    want = jax_wide.apply_streaming(img, col, block_rows=BLOCK_ROWS,
                                    strip_width=LANE)
    assert got.dtype == np.uint8 and got.shape == img.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("col", wide.WIDE_COLS)
def test_equals_the_whole_image_op(col, dtype):
    img = image(*SHAPE, seed=17)
    got = wide.apply_streaming(img, col, block_rows=BLOCK_ROWS, dtype=dtype,
                               device=CPU)
    want = whole(img, col, dtype)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h, block_rows, starts", [
    (40, 16, [0, 16, 32]),
    (33, 16, [0, 16]),      # a remainder of 1 row folds into the block
    (34, 16, [0, 16]),      # a remainder of 2 rows folds too
    (35, 16, [0, 16, 32]),  # 3 rows (halo + 1) stand alone
    (40, 2, list(range(0, 39, 3))),   # raised to halo + 1; 40 % 3 folds
    (20, 512, [0]),         # one block
    (2, 16, [0]),
])
def test_block_starts(h, block_rows, starts):
    assert wide.block_starts(h, block_rows)[1] == starts


@pytest.mark.parametrize("h, block_rows, col", [
    (33, 16, "Erosion-3x3-Square"),
    (34, 16, "Erosion-3x3-Square"),
    (40, 2, "Erosion-3x3-Square"),
    (20, 512, "Gaussian-Blur-3x3"),
    (34, 16, "Fused-Pipeline"),
])
def test_jax_edge_cases(h, block_rows, col):
    # tests/test_wide.py's short remainders, tiny blocks and single block.
    img = image(h, 200, seed=h + block_rows)
    got = wide.apply_streaming(img, col, block_rows=block_rows, device=CPU)
    np.testing.assert_array_equal(got, jax_wide.apply_streaming(
        img, col, block_rows=block_rows, strip_width=LANE))
    np.testing.assert_array_equal(got, whole(img, col, "uint8"))


@pytest.mark.parametrize("col", ["Upload", "Download", "Fused-Chain"])
def test_unknown_column_raises(col):
    with pytest.raises(ValueError, match="unknown column"):
        wide.apply_streaming(image(20, 30), col, device=CPU)
    with pytest.raises(ValueError, match="unknown column"):
        jax_wide.apply_streaming(image(20, 300), col, strip_width=LANE)


def test_unknown_dtype_raises():
    with pytest.raises(ValueError, match="Unknown dtype"):
        wide.apply_streaming(image(20, 30), "Copy", dtype="float16",
                             device=CPU)


def test_default_device_needs_a_card(monkeypatch):
    # No fallback: without a CUDA device the default device is refused.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceGateError):
        wide.apply_streaming(image(20, 30), "Copy")


@pytest.mark.parametrize("hb, row0", [(3, 0), (16, 0), (16, 16), (8, 32),
                                      (3, 37), (40, 0), (5, 17)])
def test_block_bake_equals_jax_to_wide_resident(hb, row0):
    # One strip as wide as the image: its buffer holds the port's block
    # window, which from_jax_planar cuts out.
    img = image(*SHAPE, seed=7)
    wl = jax_wide.make_wide_layout(hb, SHAPE[1], strip_width=256)
    assert wl.n_strips == 1
    strip = jax_wide.to_wide_resident(img, wl, row0=row0)[0]
    want = from_jax_planar(strip, wl.layouts[0])
    layout = make_layout(hb, SHAPE[1])
    got = to_planar_padded(img, layout, row0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    strip32 = jax_wide.to_wide_resident_f32(img, wl, row0=row0)[0]
    torch.testing.assert_close(to_planar_padded_f32(img, layout, row0),
                               from_jax_planar(strip32, wl.layouts[0]),
                               rtol=0, atol=0)


def test_block_bake_refuses_rows_past_the_image():
    layout = make_layout(16, SHAPE[1])
    with pytest.raises(ValueError, match="does not fit"):
        to_planar_padded(image(*SHAPE), layout, 25)
    with pytest.raises(ValueError, match="does not fit"):
        to_planar_padded(image(*SHAPE), layout, -1)


def stub_free_memory(monkeypatch, free: int) -> list:
    """torch.cuda.mem_get_info reports ``free`` bytes; returns the devices
    it was asked about."""
    asked = []

    def mem_get_info(device=None):
        asked.append(device)
        return free, 80 << 30
    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    return asked


def session_need(img, dtype: str, path: str) -> int:
    h, w, c = img.shape
    item = 4 if dtype == "float32" else 1
    payload = h * w * c * item
    work = (int(np.prod(make_layout(h, w).shape)) * item
            if path == "kernel" else payload)
    return payload + 2 * work


@pytest.mark.parametrize("path", ["kernel", "library"])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_cuda_session_refuses_a_buffer_past_free_memory(monkeypatch, dtype,
                                                        path):
    img = image(64, 80)
    need = session_need(img, dtype, path)
    asked = stub_free_memory(monkeypatch, need - 1)
    loads = []
    monkeypatch.setattr(session_mod.kernels, "load",
                        lambda: loads.append(1))
    with pytest.raises(ValueError, match=r"apply_streaming.*--shards"):
        BenchmarkSession(img, torch.device("cuda"), dtype=dtype, path=path)
    assert asked and not loads  # refused before the library or any upload
    stub_free_memory(monkeypatch, need)
    check_fits(img, dtype, path, torch.device("cuda"))  # fits exactly


def test_cpu_session_does_not_ask_the_card(monkeypatch):
    asked = stub_free_memory(monkeypatch, 0)
    session = BenchmarkSession(image(8, 8), CPU)
    assert session.planar_dev.device == CPU and not asked


# -- on the card ------------------------------------------------------------

TALL_SHAPE = (3, 6_300_000, 16)  # past chain_u8's 6,291,360 rows


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_every_launcher_past_its_old_height_cap_on_card(dtype):
    # chip_smoke.py [8t] (a) at the narrowest pitch: the 13 ops, C1-C4, a
    # Taps element and conv.cu's shapes (uint8: both dense bodies), kernel
    # equal to plain version.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    import chip_smoke
    errs = chip_smoke.check_tall(dtype, TALL_SHAPE)
    assert len(errs) == (18 if dtype == "uint8" else 17)
    assert not any(errs.values())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_streaming_on_card_equals_the_whole_image_op(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    img = image(3000, 200, seed=3)
    for col in wide.WIDE_COLS:
        got = wide.apply_streaming(img, col, block_rows=1000, dtype=dtype)
        layout = make_layout(*img.shape[:2])
        bake = to_planar_padded_f32 if dtype == "float32" else to_planar_padded
        ops = OPS_F32 if dtype == "float32" else OPS
        out = ops[col](bake(img, layout).cuda())
        want = (crop_planar(out, layout) if dtype == "float32"
                else from_planar_padded(out, layout))
        np.testing.assert_array_equal(got, want, err_msg=col)
