"""Self-contained test image: a deterministic synthetic fundus.

The port's own copy of ``dip_benchmark_tpu/utils/testimage.py``: the same
generator, bit-identical output (a test holds ``synth_fundus`` equal to
the JAX package's), and the same ``DIP_TPU_IMAGE`` and ``DIP_TPU_REF``
variables.

The reference ships its benchmark inputs as repo assets (assets/fundus.jpg,
a 3504x2336 HRF retina photograph). This framework must run its FULL
contract from its own tree, so instead of redistributing a third-party
photograph it ships a GENERATOR: `synth_fundus` renders a retina-like
image (dark surround, bright circular field with radial falloff, an
optic-disc hotspot, dark vessel arcs, film grain) from pure integer
arithmetic and a hand-rolled LCG hash — bit-identical on every platform,
numpy version, and image decoder.

`resolve_image` is the one lookup rule every entry point shares: an
explicit path wins, then the reference photograph when ``DIP_TPU_REF``
names a reference checkout that holds it, then the synthetic. It returns
the image together with a source label so published numbers always name
their input. Nothing is downloaded.

    python -m dip_benchmark_tpu_torch.utils.testimage out.png \
        [--height H] [--width W]

writes the synthetic fundus to a file (``utils/image.save_image``).
"""

from __future__ import annotations

import os

import numpy as np

# The HRF fundus geometry (width x height = 3504 x 2336); the synthetic
# default matches it so bench numbers are size-comparable either way.
FUNDUS_H, FUNDUS_W = 2336, 3504


def ref_path(rel: str) -> str | None:
    """Path of a file inside the reference checkout named by
    ``$DIP_TPU_REF``, or None when the variable is not set."""
    root = os.environ.get("DIP_TPU_REF")
    return os.path.join(root, rel) if root else None


def _lcg_noise(h: int, w: int, lo: int, hi: int, salt: int) -> np.ndarray:
    """Per-pixel integer hash noise in [lo, hi] — a Knuth-style LCG over
    the pixel index, stable forever (no numpy RNG stream dependence)."""
    idx = (np.arange(h, dtype=np.uint64)[:, None] * np.uint64(w)
           + np.arange(w, dtype=np.uint64)[None, :]
           + np.uint64(salt * 0x9E3779B9))
    x = (idx * np.uint64(6364136223846793005)
         + np.uint64(1442695040888963407)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x ^= x >> np.uint64(33)
    span = hi - lo + 1
    return ((x >> np.uint64(24)) % np.uint64(span)).astype(np.int32) + lo


def synth_fundus(height: int = FUNDUS_H, width: int = FUNDUS_W
                 ) -> np.ndarray:
    """Deterministic retina-like RGB uint8 image (see module docstring).

    Integer arithmetic only: the same (height, width) yields the same
    bytes everywhere. Covers the structures the op matrix exercises —
    smooth gradients (blur/convolution visibly act), hard circular edges
    (border and rounding bugs show), thin dark curves (erosion eats them),
    full dynamic range (threshold and inversion are non-trivial), and
    grain (min-filters and separable passes differ from their fused forms).
    """
    h, w = height, width
    yy = np.arange(h, dtype=np.int64)[:, None]
    xx = np.arange(w, dtype=np.int64)[None, :]
    cy, cx = h // 2, w // 2
    r2 = (yy - cy) ** 2 + (xx - cx) ** 2

    # Bright circular field with quadratic radial falloff to a dark rim.
    rad = (min(h, w) * 48) // 100
    field = np.clip((rad * rad - r2) * 220 // max(rad * rad, 1), 0, 220)

    # Optic disc: a small bright hotspot right of center.
    dy, dx = cy - h // 12, cx + w // 6
    d2 = (yy - dy) ** 2 + (xx - dx) ** 2
    drad = min(h, w) // 14
    disc = np.clip((drad * drad - d2) * 90 // max(drad * drad, 1), 0, 90)

    # Vessels: dark parabolic arcs fanning out of the disc, a few pixels
    # wide, with the arc family parameterized by small integer ratios.
    vessel = np.zeros((h, w), np.int64)
    for k, (num, den, off) in enumerate(
            ((1, 9, -5), (-1, 7, 4), (1, 4, -11), (-1, 3, 9),
             (1, 14, 1), (-1, 16, -2))):
        yc = dy + off * h // 96 + num * (xx - dx) ** 2 // (den * w)
        dist = np.abs(yy - yc)
        t = 1 + max(h, w) // 900 + (k % 3)
        vessel = np.maximum(vessel, np.where(dist <= t, 70 - 12 * (k % 3),
                                             0))
    inside = (r2 < rad * rad).astype(np.int64)
    base = field + disc - vessel * inside

    grain = _lcg_noise(h, w, -4, 4, salt=1)
    r = np.clip(base + 30 * inside + grain, 0, 255)
    g = np.clip(base * 55 // 100 + _lcg_noise(h, w, -3, 3, salt=2), 0, 255)
    b = np.clip(base * 22 // 100 + _lcg_noise(h, w, -3, 3, salt=3), 0, 255)
    return np.stack([r, g, b], axis=-1).astype(np.uint8)


def resolve_image(path: str | None = None, height: int = FUNDUS_H,
                  width: int = FUNDUS_W) -> tuple[np.ndarray, str]:
    """The shared input rule: explicit `path` (or $DIP_TPU_IMAGE) wins;
    else the reference fundus photograph under $DIP_TPU_REF when it is
    there; else the synthetic at (height, width). Returns (HWC uint8
    image, source label for publication next to any number measured on
    it)."""
    from .image import load_image
    path = path or os.environ.get("DIP_TPU_IMAGE")
    if path:
        return load_image(path), os.path.basename(path)
    fundus = ref_path("assets/fundus.jpg")
    if fundus and os.path.exists(fundus):
        return load_image(fundus), "fundus.jpg"
    return (synth_fundus(height, width),
            f"synth_fundus({height}x{width})")


def _main(argv: list[str] | None = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="Write the deterministic synthetic fundus to a file")
    ap.add_argument("out", help="output path (.png recommended: lossless)")
    ap.add_argument("--height", type=int, default=FUNDUS_H)
    ap.add_argument("--width", type=int, default=FUNDUS_W)
    args = ap.parse_args(argv)
    from .image import save_image
    save_image(args.out, synth_fundus(args.height, args.width))
    print(f"wrote {args.out} ({args.height}x{args.width})")


if __name__ == "__main__":
    _main()
