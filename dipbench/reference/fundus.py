"""The benchmark's input: a seeded synthetic fundus, made on the device.

A frozen copy of the synthetic fundus of the port's ``utils/testimage``
(a retina-like RGB uint8 image: a bright circular field with radial
falloff, an optic-disc hotspot, dark vessel arcs and film grain, in
integer arithmetic only), with two changes: the grain comes from a 32-bit
integer hash salted by the run's seed, and the image is made by torch on
any device, so a run makes it on the card in a few large calls. Integer
arithmetic only, so the same seed gives the same bytes on every device.

``pool`` varies one generated fundus cheaply into several images (a
seeded circular shift and flip each), for the batch traffic.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
M64 = 0xFFFFFFFFFFFFFFFF


def mix64(x: int) -> int:
    """splitmix64's finaliser: a well-spread 64-bit value of any integer."""
    x = (x + 0x9E3779B97F4A7C15) & M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & M64
    return x ^ (x >> 31)


def salt(seed: int, stream: int) -> int:
    """A 32-bit salt for one use (``stream``) of the run's seed."""
    return mix64(mix64(seed & M64) ^ stream) & M32


def hash_noise(idx: torch.Tensor, lo: int, hi: int,
               salt32: int) -> torch.Tensor:
    """Integer noise in [lo, hi] of each pixel index in ``idx`` (int64,
    below 2**32): two rounds of a 32-bit multiply-xorshift hash. Every
    product stays below 2**63, so int64 arithmetic on any device is exact."""
    h = (idx ^ salt32) & M32
    for _ in range(2):
        h = ((h >> 16) ^ h) * 0x45D9F3B & M32
    h = (h >> 16) ^ h
    return (h % (hi - lo + 1)) + lo


def fundus(height: int, width: int, seed: int,
           device: torch.device | str = "cpu") -> torch.Tensor:
    """The (height, width, 3) uint8 fundus of ``seed`` on ``device``."""
    h, w = height, width
    i64 = dict(dtype=torch.int64, device=device)
    yy = torch.arange(h, **i64)[:, None]
    xx = torch.arange(w, **i64)[None, :]
    cy, cx = h // 2, w // 2
    r2 = (yy - cy) ** 2 + (xx - cx) ** 2

    rad = (min(h, w) * 48) // 100
    field = ((rad * rad - r2) * 220 // max(rad * rad, 1)).clamp(0, 220)

    dy, dx = cy - h // 12, cx + w // 6
    d2 = (yy - dy) ** 2 + (xx - dx) ** 2
    drad = min(h, w) // 14
    disc = ((drad * drad - d2) * 90 // max(drad * drad, 1)).clamp(0, 90)

    vessel = torch.zeros((h, w), **i64)
    for k, (num, den, off) in enumerate(
            ((1, 9, -5), (-1, 7, 4), (1, 4, -11), (-1, 3, 9),
             (1, 14, 1), (-1, 16, -2))):
        # Floor division of a possibly negative numerator, as Python's.
        yc = dy + off * h // 96 + torch.div(
            num * (xx - dx) ** 2, den * w, rounding_mode="floor")
        dist = (yy - yc).abs()
        t = 1 + max(h, w) // 900 + (k % 3)
        vessel = torch.maximum(
            vessel, torch.where(dist <= t, 70 - 12 * (k % 3), 0))
    inside = (r2 < rad * rad).to(torch.int64)
    base = field + disc - vessel * inside

    idx = yy * w + xx
    r = (base + 30 * inside + hash_noise(idx, -4, 4, salt(seed, 1)))
    g = base * 55 // 100 + hash_noise(idx, -3, 3, salt(seed, 2))
    b = base * 22 // 100 + hash_noise(idx, -3, 3, salt(seed, 3))
    return torch.stack([r, g, b], dim=-1).clamp(0, 255).to(torch.uint8)


def pool(image: torch.Tensor, n: int, seed: int) -> torch.Tensor:
    """``n`` images varied from ``image`` (H, W, 3): each a circular shift
    by a seeded row and column offset, every other one mirrored left to
    right. The first is ``image`` itself."""
    h, w, _ = image.shape
    out = [image]
    for i in range(1, n):
        s = salt(seed, 100 + i)
        v = torch.roll(image, (s % h, (s >> 12) % w), dims=(0, 1))
        out.append(v.flip(1) if i % 2 else v)
    return torch.stack(out)
