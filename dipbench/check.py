"""The comparison that decides ``correct``.

What the timed path produced is set against the plain reference
(``dipbench/reference/ops.py``), which a traffic driver
(``dipbench/drivers/<driver>.py``, its ``expected``) uses to work every
output out again from the run's own inputs at the timed sizes. The
reference of a column is found by its name (``ref.OPS``), and a
sequence of columns is their application one after the other.

The number compared is the widest gap, in output levels (1/255 of the
float32 range), between a program output and the reference's, outside
the float32 model's don't-care pixels (a threshold on a computed luma
within 4 ulps of its step, and all that the later stages reach from
them). A program output named ``<name>#<n>`` (one of several samples)
is judged against the reference's ``<name>``. ``precision`` puts the
reference in the program's place at a lower precision: the control.
"""

from __future__ import annotations

import torch

from dipbench.reference import ops as ref


def _levels(a: torch.Tensor, b: torch.Tensor, model: str) -> torch.Tensor:
    if model == "uint8":
        return (a.to(torch.int32) - b.to(torch.int32)).abs()
    return (a.to(torch.float64) - b.to(torch.float64)).abs() * 255.0


def gap(a: torch.Tensor, b: torch.Tensor, model: str,
        dontcare: torch.Tensor | None = None) -> float:
    """The widest gap in levels between ``a`` and ``b``; a NaN anywhere
    reads NaN. ``dontcare`` is a mask that broadcasts to their shape."""
    if a.shape != b.shape:
        return float("inf")
    d = _levels(a, b, model)
    if dontcare is not None:
        d = d.masked_fill(dontcare, 0)
    if torch.isnan(d).any():
        return float("nan")
    return float(d.max()) if d.numel() else 0.0


def single(cols: list[str], image: torch.Tensor, model: str,
           precision: str) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The columns ``cols`` applied one after the other to an (H, W, 3)
    uint8 image, each as one application through the bake and the crop;
    returns (H, W, 3) and the (H, W, 1) don't-care mask or None. A
    sequence is defined for the uint8 model only (the float32 model's
    don't-care of a threshold inside a sequence is not written here)."""
    if model != "uint8" and len(cols) > 1:
        raise ValueError("a sequence of columns has a reference in the "
                         "uint8 model only")
    h, w, _ = image.shape
    x, care = image, None
    for col in cols:
        planar = ref.bake(x, 2, w + 4)
        if model == "float32":
            planar = ref.to_float(planar)
        out, care = ref.apply_k(col, planar, 1, precision)
        x = ref.crop(out, h, w)
    if care is not None:
        care = care[2:2 + h, 2:2 + w, None]
    return x, care


def compare(model: str, got: dict, want: dict) -> dict:
    """Each program output's gap to the reference's."""
    gaps = {}
    for name, out in got.items():
        ref_out, care = want[base(name)]
        gaps[name] = gap(out, ref_out, model, care)
    return gaps


def base(name: str) -> str:
    """The reference output a program output is judged against."""
    return name.split("#")[0]


def missing(expected_names, got: dict) -> int:
    """How many of the outputs a run has to produce it did not."""
    have = {base(n) for n in got}
    return len({base(n) for n in expected_names} - have)


def dontcare_share(want: dict) -> float:
    """The share of positions the don't-care masks leave out."""
    masks = [c for _, c in want.values() if c is not None]
    if not masks:
        return 0.0
    return float(sum(m.float().mean() for m in masks)) / len(want)
