"""Traffic of session rounds: a ``BenchmarkSession`` of the port over one
image, its rows cycled in order. A round is one ``run`` of a row, what
the CLI times: the op's launch (or one CUDA-graph replay of ``k``
applications) and the synchronize that ends it.

A mix's parameters:

- ``k``: each round replays ``k`` chained applications
  (``chained_operations``); without it a round is one application
  (``operations``);
- ``rows``: the rows, by CSV column, in the order they cycle: the
  matrix's, ``Upload`` and ``Download`` among them, and
  ``Fused-Pipeline``; by default every on-device row and the pipeline;
- ``fuse``: chains, each a list of columns, added as rows that run the
  chain fused into one launch (``chain_operation``; single applications,
  uint8), named by their columns joined with commas;
- ``warmup``: cycles of the rows before the window (set-up);
- ``trace_rounds``: rounds in the traced sub-window.

What the check judges: each row's output of its last round, through the
port's crop for single applications, the whole padded buffer for
chained ones, the transferred image for the memory rows.
"""

from __future__ import annotations

import numpy as np
import torch

from dipbench import check
from dipbench.reference import fundus
from dipbench.reference import ops as ref

MEMORY = ("Upload", "Download")


def make_inputs(cfg: dict, mix: dict, seed: int, device,
                size=None) -> np.ndarray:
    """The host image (H, W, 3), made on ``device`` from ``seed``."""
    h, w = size or (cfg["height"], cfg["width"])
    return np.ascontiguousarray(fundus.fundus(h, w, seed, device).cpu()
                                .numpy())


def row_names(mix: dict) -> list[str]:
    """The rows of the mix, in the order they cycle."""
    rows = list(mix.get("rows", ref.OPS))
    if "k" in mix and (set(rows) & set(MEMORY) or mix.get("fuse")):
        raise ValueError("chained rounds take on-device matrix rows only")
    return rows + [",".join(cols) for cols in mix.get("fuse", [])]


class Driver:
    def __init__(self, cfg: dict, mix: dict, inputs: np.ndarray, seed: int,
                 device, spans=None):
        from dip_benchmark_tpu_torch.session import BenchmarkSession
        from dip_benchmark_tpu_torch.utils.image import from_planar_padded
        self._crop = from_planar_padded
        self.k = int(mix.get("k", 1))
        self.names = row_names(mix)
        s = self.session = BenchmarkSession(inputs, device,
                                            dtype=cfg["dtype"],
                                            path="kernel")
        if spans is not None and "k" not in mix:
            # The span runs from the call of the op's entry to its
            # return, before the round's synchronize.
            s._ops = {col: spans.wrap(fn) for col, fn in s._ops.items()}
        table = (s.chained_operations(self.k, True) if "k" in mix
                 else s.operations(True))
        by_col = {op.csv_column: op for op in table}
        fuse = mix.get("fuse", [])
        self.ops = [by_col[n] for n in self.names[:len(self.names)
                                                   - len(fuse)]]
        for cols in fuse:
            if cfg["dtype"] != "uint8":
                raise ValueError("fused chains are checked in uint8 only")
            self.ops.append(s.chain_operation(list(cols)))
        self._last: dict[str, object] = {}

    def step(self, i: int) -> None:
        ret = self.ops[i].run()
        name = self.names[i]
        self._last[name] = ret if name in MEMORY else self.session._sample

    def items(self, rounds: int) -> int:
        return rounds * self.k

    def outputs(self) -> dict:
        """Each row's output of its last round, on the session's device."""
        out = {}
        dev = self.session.device
        for name, t in self._last.items():
            if name in MEMORY:
                out[name] = torch.as_tensor(t).to(dev)
            elif self.k > 1:
                out[name] = t
            elif "," in name:
                # A chain's buffer has the chain's halo: the port's crop
                # of its row.
                self.session._sample = t
                op = self.ops[self.names.index(name)]
                out[name] = torch.from_numpy(op.fetch()).to(dev)
            else:
                out[name] = torch.from_numpy(
                    self._crop(t, self.session.layout)).to(dev)
        return out

    def close(self) -> None:
        self.session = self.ops = self._last = None


def output_shapes(cfg: dict, mix: dict, inputs: np.ndarray) -> dict:
    """The outputs a run judges and their shapes (a chained row's is its
    whole buffer's, the port's layout), without running the program."""
    from dip_benchmark_tpu_torch.utils.image import make_layout
    h, w, c = inputs.shape
    shape = make_layout(h, w, c).shape if "k" in mix else (h, w, c)
    return {n: shape for n in row_names(mix)}


def expected(cfg: dict, mix: dict, inputs: np.ndarray, shapes: dict,
             precision: str, device) -> dict:
    """The reference's output of each row in ``shapes``, with its
    don't-care mask or None."""
    model = cfg["dtype"]
    image = torch.from_numpy(inputs).to(device)
    h, w, _ = image.shape
    out = {}
    for name, shape in shapes.items():
        if name in MEMORY:
            # The data model's image on the card: uint8 HWC, or float32
            # (3, H, W) in [0, 1].
            out[name] = ((image, None) if model == "uint8"
                         else (ref.to_float(image.permute(2, 0, 1)), None))
        elif "k" in mix:
            pad = (shape[-2] - h) // 2
            planar = ref.bake(image, pad, shape[-1])
            if model == "float32":
                planar = ref.to_float(planar)
            out[name] = ref.apply_k(name, planar, int(mix["k"]), precision)
        else:
            out[name] = check.single(name.split(","), image, model,
                                     precision)
    return out
