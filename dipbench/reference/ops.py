"""Plain reference of the op matrix, in plain torch, on any device.

Written from the semantics the port states, not from its code; it
imports nothing of the port. Each op maps a mirror-padded planar buffer
``(3, Hp, pitch)`` to one of the same shape, as the port's ops do: a
point op over the whole buffer, a windowed op wherever all its taps lie
in the buffer and 0 in its outer ring of ``r`` rows and columns, so K
applications compose on one buffer (the chained traffic). ``bake`` makes
that buffer from an image, ``crop`` takes the image back out.

The uint8 model: integer fixed point (``uint8`` data, ``int32`` sums),
bit-exact. Grayscale is ``(13933 R + 46871 G + 4732 B) >> 16`` to all
three planes; threshold ``255 if x > 127 else 0``; erosions the minimum
over the element; the binomial convolutions ``(sum + half) >> shift``,
clamped, the separable ones rounded to uint8 between the row pass (over
every padded row) and the column pass. The float32 model: planes in
[0, 1], luma ``(R wr + G wg) + B wb``, threshold ``x > 0.5``, the
convolutions as float sums unrounded between passes, each product and
each sum rounded once, in the port's stated order (dense: each mask
column's sum over its rows, then the sum of the columns; separable: the
row pass, then the column pass; the 3x3 blur ``(a q + b h) + c q``
vertically, then horizontally).

``precision`` selects the arithmetic: ``"int32"`` and ``"float32"`` are
the configurations' own; ``"int16"`` and ``"bfloat16"`` the next lower
ones, which make the control that the comparison has to fail.
"""

from __future__ import annotations

import numpy as np
import torch

LUMA_INT = (13933, 46871, 4732)
LUMA_SHIFT = 16
# Rec.709 weights as float32 values.
LUMA_F32 = tuple(float(np.float32(w)) for w in (0.2126, 0.7152, 0.0722))
THRESHOLD = 127
# |luma - 0.5| at or under this may flip the f32 threshold between two
# orders of the luma sum (4 ulps at 0.5): the f32 model's don't-care.
NEAR_HALF = 2.0 ** -22

BLUR3 = (1, 2, 1)
BLUR5 = (1, 4, 6, 4, 1)
CROSS = ((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0))
SQUARE = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))

# Each column of the matrix: (kind, arguments). Dense convolutions take
# the 1-D binomial whose outer product is the mask, and its shift.
OPS = {
    "Copy": ("copy", ()),
    "Inversion": ("invert", ()),
    "Grayscale": ("gray", ()),
    "Threshold": ("threshold", ()),
    "Erosion-3x3-Cross": ("erode", (CROSS,)),
    "Erosion-3x3-Square": ("erode", (SQUARE,)),
    "Erosion-1x3+3x1-Square": ("erode_sep", ()),
    "Convolution-3x3": ("conv", (BLUR3, 4)),
    "Convolution-1x3+3x1": ("conv_sep", (BLUR3, 2)),
    "Convolution-5x5": ("conv", (BLUR5, 8)),
    "Convolution-1x5+5x1": ("conv_sep", (BLUR5, 4)),
    "Gaussian-Blur-3x3": ("blur", ()),
    "Fused-Pipeline": ("pipeline", ()),
}
ACC = {"int32": torch.int32, "int16": torch.int16,
       "float32": torch.float32, "bfloat16": torch.bfloat16}
MODEL_OF = {"int32": "uint8", "int16": "uint8", "float32": "float32",
            "bfloat16": "float32"}


def mirror(i: torch.Tensor, n: int) -> torch.Tensor:
    """The border rule: -i below 0, 2n - i - 1 from n on, clamped."""
    i = torch.where(i < 0, -i, i)
    i = torch.where(i >= n, 2 * n - i - 1, i)
    return i.clamp(0, n - 1)


def bake(image: torch.Tensor, pad: int, pitch: int) -> torch.Tensor:
    """(H, W, 3) uint8 -> (3, H + 2 pad, pitch) uint8: every row and
    column, the halo and the slack past ``W + 2 pad`` included, taken from
    the image by the border rule."""
    h, w, _ = image.shape
    dev = image.device
    rows = mirror(torch.arange(h + 2 * pad, device=dev) - pad, h)
    cols = mirror(torch.arange(pitch, device=dev) - pad, w)
    return image.permute(2, 0, 1)[:, rows][:, :, cols].contiguous()


def to_float(planar: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 x / 255, each value rounded as IEEE division
    rounds it (a table made on the host, so no device division enters)."""
    table = torch.from_numpy(np.arange(256, dtype=np.float32)
                             / np.float32(255)).to(planar.device)
    return table[planar.long()]


def crop(planar: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(..., 3, Hp, pitch) -> (..., H, W, 3), the image inside the halo."""
    pad = (planar.shape[-2] - height) // 2
    return planar[..., pad:pad + height, pad:pad + width].movedim(-3, -1)


def _ring(core: torch.Tensor, like: torch.Tensor, r: int) -> torch.Tensor:
    out = torch.zeros(like.shape, dtype=core.dtype, device=like.device)
    out[:, r:like.shape[1] - r, r:like.shape[2] - r] = core
    return out


def _tap(x: torch.Tensor, r: int, dy: int, dx: int) -> torch.Tensor:
    _, hp, pitch = x.shape
    return x[:, r + dy:hp - r + dy, r + dx:pitch - r + dx]


class Arith:
    """The arithmetic of one precision."""

    def __init__(self, precision: str):
        self.acc = ACC[precision]
        self.model = MODEL_OF[precision]
        self.int = self.model == "uint8"

    def wide(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.acc)

    def const(self, v: float | int) -> torch.Tensor:
        """A weight in this precision (an integer wraps as the type
        does)."""
        if self.int:
            bits = torch.iinfo(self.acc).bits
            v = (int(v) + (1 << bits - 1)) % (1 << bits) - (1 << bits - 1)
        return torch.tensor(v, dtype=self.acc)

    def out(self, acc: torch.Tensor, shift: int = 0) -> torch.Tensor:
        """An integer sum rounded half up by ``shift`` and clamped to
        uint8; a float value back to float32."""
        if not self.int:
            return acc.to(torch.float32)
        if shift:
            acc = (acc + self.const(1 << shift >> 1).to(acc.device)) >> shift
        return acc.clamp(0, 255).to(torch.uint8)


def _gray(x: torch.Tensor, a: Arith) -> torch.Tensor:
    """The luma plane, in the precision's own type."""
    w = a.wide(x)
    dev = x.device
    if a.int:
        wr, wg, wb = (a.const(c).to(dev) for c in LUMA_INT)
        return (w[0] * wr + w[1] * wg + w[2] * wb) >> LUMA_SHIFT
    wr, wg, wb = (a.const(c).to(dev) for c in LUMA_F32)
    return (w[0] * wr + w[1] * wg) + w[2] * wb


def _threshold(x: torch.Tensor, a: Arith) -> torch.Tensor:
    if a.int:
        return torch.where(x > THRESHOLD, 255, 0).to(torch.uint8)
    return (x > 0.5).to(torch.float32)


def _min(x: torch.Tensor, taps, r: int) -> torch.Tensor:
    core = None
    for dy, dx in taps:
        t = _tap(x, r, dy, dx)
        core = t if core is None else torch.minimum(core, t)
    return _ring(core, x, r)


def _conv(x: torch.Tensor, a: Arith, taps1d, shift: int) -> torch.Tensor:
    """Dense correlation with outer(taps1d, taps1d) / 2**shift."""
    n = len(taps1d)
    r = n // 2
    w = a.wide(x)
    dev = x.device
    if a.int:
        acc = 0
        for ky in range(n):
            for kx in range(n):
                acc = acc + _tap(w, r, ky - r, kx - r) * a.const(
                    taps1d[ky] * taps1d[kx]).to(dev)
        return _ring(a.out(acc, shift), x, r)
    acc = None
    for kx in range(n):
        col = None
        for ky in range(n):
            t = _tap(w, r, ky - r, kx - r) * a.const(
                taps1d[ky] * taps1d[kx] / (1 << shift)).to(dev)
            col = t if col is None else col + t
        acc = col if acc is None else acc + col
    return _ring(a.out(acc), x, r)


def _conv_sep(x: torch.Tensor, a: Arith, taps1d, shift: int) -> torch.Tensor:
    """The 1xN pass over every padded row, then the Nx1 pass; the uint8
    model rounds to uint8 between them."""
    n = len(taps1d)
    r = n // 2
    _, hp, pitch = x.shape
    w = a.wide(x)
    dev = x.device
    scale = 1 if a.int else 1 << shift
    rows = None
    for kx in range(n):
        t = w[..., kx:pitch - 2 * r + kx] * a.const(
            taps1d[kx] / scale if not a.int else taps1d[kx]).to(dev)
        rows = t if rows is None else rows + t
    if a.int:
        rows = a.wide(a.out(rows, shift))
    acc = None
    for ky in range(n):
        t = rows[:, ky:hp - 2 * r + ky] * a.const(
            taps1d[ky] / scale if not a.int else taps1d[ky]).to(dev)
        acc = t if acc is None else acc + t
    return _ring(a.out(acc, shift if a.int else 0), x, r)


def _blur(x: torch.Tensor, a: Arith) -> torch.Tensor:
    """The 1-2-1 x 1-2-1 blur, ring 1."""
    if a.int:
        return _conv(x, a, BLUR3, 4)
    _, hp, pitch = x.shape
    w = a.wide(x)
    q, h = (a.const(v).to(x.device) for v in (0.25, 0.5))
    col = (w[:, 0:hp - 2] * q + w[:, 1:hp - 1] * h) + w[:, 2:hp] * q
    o = (col[..., 0:pitch - 2] * q + col[..., 1:pitch - 1] * h) \
        + col[..., 2:pitch] * q
    return _ring(a.out(o), x, 1)


def apply(col: str, x: torch.Tensor, a: Arith) -> tuple[torch.Tensor,
                                                       torch.Tensor | None]:
    """One application of column ``col`` to the planar ``x``; returns the
    output and, for the float32 pipeline, the (Hp, pitch) mask of pixels
    whose luma lies within ``NEAR_HALF`` of the threshold step (else
    None)."""
    kind, args = OPS[col]
    if kind == "copy":
        return x.clone(), None
    if kind == "invert":
        if a.int:
            return (255 - x.to(torch.int32)).to(torch.uint8), None
        return a.out(a.const(1.0).to(x.device) - a.wide(x)), None
    if kind == "gray":
        g = _gray(x, a)
        g = g.clamp(0, 255).to(torch.uint8) if a.int else a.out(g)
        return g.expand(3, -1, -1).contiguous(), None
    if kind == "threshold":
        return _threshold(a.wide(x) if not a.int else x, a), None
    if kind == "erode":
        return _min(x, args[0], 1), None
    if kind == "erode_sep":
        return _min(x, SQUARE, 1), None
    if kind == "conv":
        return _conv(x, a, *args), None
    if kind == "conv_sep":
        return _conv_sep(x, a, *args), None
    if kind == "blur":
        return _blur(x, a), None
    # The pipeline: grayscale, threshold, 3x3 square erosion, blur, with
    # the outer ring of 2 set to 0.
    g = _gray(x, a)
    near = None
    if a.int:
        t = _threshold(g.clamp(0, 255).to(torch.uint8), a)
    else:
        near = (g.to(torch.float32) - 0.5).abs() <= NEAR_HALF
        t = _threshold(g, a)
    eroded = _min(t.expand(3, -1, -1), SQUARE, 1)
    out = _blur(eroded, a)
    return _ring(_tap(out, 2, 0, 0), out, 2), near


def dilate(mask: torch.Tensor, r: int) -> torch.Tensor:
    """Box dilation of an (Hp, pitch) bool mask by ``r``."""
    if r == 0:
        return mask
    pool = torch.nn.functional.max_pool2d
    f = mask[None, None].to(torch.float32)
    f = pool(f, (2 * r + 1, 1), 1, (r, 0))
    return pool(f, (1, 2 * r + 1), 1, (0, r))[0, 0] > 0


def apply_k(col: str, planar: torch.Tensor, k: int, precision: str
            ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """``k`` applications of ``col``, ``y = op(y)``, starting from the
    planar buffer of the configuration's model (uint8, or float32 in
    [0, 1]). Returns the output in float32 or uint8 and the don't-care
    mask (Hp, pitch), or None where no pixel is don't-care: where a
    float32 threshold met a luma within ``NEAR_HALF`` of its step, the
    pixels the later stages and applications reach from it (2 a stage
    pair, erosion and blur, per application left)."""
    a = Arith(precision)
    x = planar if a.int else planar.to(a.acc)
    care = None
    for i in range(k):
        x, near = apply(col, x, a)
        if not a.int:
            x = x.to(a.acc)
        if near is not None and bool(near.any()):
            m = dilate(near, 2 * (k - i))
            care = m if care is None else care | m
    if not a.int:
        x = x.to(torch.float32)
    return x, care
