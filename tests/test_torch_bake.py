"""The batch tool's bake of a stack on the card: ``bake_u8`` (csrc/layout.cu,
through ``ops/layout.bake_stack``) and ``process_batch`` on the card (bake,
op and crop), held to ``utils/image.stack_planar_padded`` and the oracle
at tolerance 0.

The tests here are card-only and skip without a CUDA device. They need
neither JAX nor ``conftest.py``:

    python -m pytest --noconftest tests/test_torch_bake.py -m cuda

``BAKE_CASES`` and ``bake_case`` are shared with the plain bake's tests in
tests/test_torch_layout.py.
"""

import numpy as np
import pytest
import torch

from dip_benchmark_tpu_torch import oracle
from dip_benchmark_tpu_torch.models import batch, chain
from dip_benchmark_tpu_torch.ops import kernels
from dip_benchmark_tpu_torch.ops.layout import bake_stack
from dip_benchmark_tpu_torch.runtime import tracing
from dip_benchmark_tpu_torch.utils.image import make_layout, stack_planar_padded


def slack_width(pad: int, slack: int) -> int:
    """The least width of at least pad + 1 whose pitch leaves ``slack``
    columns past the right halo."""
    w = pad + 1
    while make_layout(pad + 1, w, pad=pad).pitch - (w + 2 * pad) != slack:
        w += 1
    return w


# (B, H, W, pad): each pad at the smallest image it takes, at a width with
# no pitch slack and one with 15 columns of it, and at 37x53 (odd sides,
# rows of 159 bytes); B 1 to 3.
BAKE_CASES = [
    (1 + (i + j) % 3, h, w, pad)
    for i, pad in enumerate((2, 3, 5, 8))
    for j, (h, w) in enumerate([(pad + 1, pad + 1),
                                (pad + 4, slack_width(pad, 0)),
                                (pad + 6, slack_width(pad, 15)),
                                (37, 53)])]


def bake_case(b, h, w, pad, seed=0):
    images = np.random.default_rng(seed + 97 * pad + w).integers(
        0, 256, (b, h, w, 3), np.uint8)
    return images, make_layout(h, w, pad=pad)


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,pad", BAKE_CASES + [
    (8, 2336, 3504, 2),     # the fundus stack of the batch cell
    (2, 64, 1001, 3),       # rows of 3,003 bytes: no row on a 16-byte edge
    (1, 9, 9000, 8),        # three tiles of 4,096 columns
    (2, 7, 4095, 5),        # a tile's edge inside the right halo
])
def test_bake_stack_on_card_is_the_host_bake(b, h, w, pad):
    card()
    images, layout = bake_case(b, h, w, pad)
    kernels.reset_launches()
    got = bake_stack(torch.from_numpy(images).cuda(), layout)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"bake_u8": 1}
    assert torch.equal(got.cpu(), stack_planar_padded(images, layout))


@pytest.mark.cuda
def test_bake_stack_on_card_reads_an_unaligned_stack():
    card()
    images, layout = bake_case(2, 37, 64, 2)
    buf = torch.empty(images.size + 5, dtype=torch.uint8, device="cuda")
    stack = buf[5:].view(images.shape)
    stack.copy_(torch.from_numpy(images))
    assert stack.is_contiguous() and stack.data_ptr() % 16 == 5
    got = bake_stack(stack, layout)
    assert torch.equal(got.cpu(), stack_planar_padded(images, layout))


@pytest.mark.cuda
@pytest.mark.parametrize("cols", ["Fused-Pipeline",
                                  ["Erosion-3x3-Square", "Gaussian-Blur-3x3",
                                   "Convolution-5x5", "Convolution-1x5+5x1",
                                   "Inversion"]])
def test_process_batch_on_card_bakes_on_the_card(cols):
    card()
    images, _ = bake_case(3, 37, 53, 2, seed=5)
    tracing.enable()
    kernels.reset_launches()
    try:
        got = batch.process_batch(images, cols)
        snap = tracing.snapshot()
    finally:
        tracing.disable()
    if cols == "Fused-Pipeline":
        assert kernels.LAUNCHES == {"bake_u8": 1, "pipeline_u8": 1,
                                    "crop_u8": 1}
        want = [oracle.fused_pipeline(im) for im in images]
    else:
        assert max(2, *chain.check_chain(cols)) >= 3
        assert kernels.LAUNCHES == {"bake_u8": 1, "chain_u8": 1,
                                    "crop_u8": 1}
        want = [chain.chain_row_parts(cols)[2](im) for im in images]
    assert snap.counters["card_bakes"] == snap.counters["images"] == 3
    assert snap.counters["card_crops"] == 3 and snap.spans["crop"][0] == 1
    # The result is the pinned buffer the card copied into, not a copy.
    assert torch.from_numpy(got).is_pinned()
    for i in range(3):
        np.testing.assert_array_equal(got[i], want[i])


@pytest.mark.cuda
def test_process_batch_on_card_stages_a_library_column(monkeypatch):
    # A single op takes the pipeline's upload: the page-locked staging
    # stack inside the bake span, no pin_memory() of the whole stack, and
    # no bake or crop on the card.
    card()
    images, _ = bake_case(3, 37, 53, 2, seed=6)
    opened, open_now = [], []

    class Span:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            open_now.append(self.name)
            opened.append("/".join(open_now))

        def __exit__(self, *exc):
            open_now.pop()

    def whole_stack_pin(self, *args, **kwargs):
        raise AssertionError("pin_memory() of the whole stack")

    monkeypatch.setattr(tracing, "span", Span)
    monkeypatch.setattr(torch.Tensor, "pin_memory", whole_stack_pin)
    kernels.reset_launches()
    got = batch.process_batch(images, "Grayscale")
    assert kernels.LAUNCHES == {}
    assert opened == ["batch", "batch/bake", "batch/bake/pin_alloc",
                      "batch/bake/alloc", "batch/pin_alloc"]
    assert torch.from_numpy(got).is_pinned()
    np.testing.assert_array_equal(
        got, batch.process_batch(images, "Grayscale", device="cpu"))
