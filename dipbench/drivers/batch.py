"""Traffic of the batch tool: ``models.batch.process_batch`` of one stack
of images, one caller in a closed loop; a round is one call.

A mix's parameters:

- ``op``: the column the batch runs, or a list of columns, a chain;
- ``batch``: the images in the stack (one seeded fundus, varied by
  ``fundus.pool``);
- ``sample``: how many of the returned stacks the check judges, a
  seeded reservoir of all the window returned (default 3);
- ``warmup``, ``trace_rounds``: calls before the window, and in the
  traced sub-window.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from dipbench import check
from dipbench.reference import fundus


def _cols(mix: dict) -> list[str]:
    op = mix["op"]
    return [op] if isinstance(op, str) else list(op)


def make_inputs(cfg: dict, mix: dict, seed: int, device,
                size=None) -> np.ndarray:
    """The host stack (B, H, W, 3), made on ``device`` from ``seed``."""
    h, w = size or (cfg["height"], cfg["width"])
    image = fundus.fundus(h, w, seed, device)
    stack = fundus.pool(image, int(mix["batch"]), seed)
    return np.ascontiguousarray(stack.cpu().numpy())


class Driver:
    def __init__(self, cfg: dict, mix: dict, inputs: np.ndarray, seed: int,
                 device, spans=None):
        from dip_benchmark_tpu_torch.models import batch
        if cfg["dtype"] != "uint8":
            raise ValueError("the batch tool runs the uint8 model")
        self._process = batch.process_batch
        cols = _cols(mix)
        self.op = cols[0] if isinstance(mix["op"], str) else cols
        self.stack = inputs
        self.device = device
        self.names = ["stack"]
        self.keep = int(mix.get("sample", 3))
        self._rng = random.Random(seed)
        self._seen = 0
        self._sample: list[tuple[int, np.ndarray]] = []

    def step(self, i: int) -> None:
        out = self._process(self.stack, self.op, device=self.device)
        self._seen += 1
        if len(self._sample) < self.keep:
            self._sample.append((self._seen, out))
        else:
            j = self._rng.randrange(self._seen)
            if j < self.keep:
                self._sample[j] = (self._seen, out)

    def items(self, rounds: int) -> int:
        return rounds * len(self.stack)

    def outputs(self) -> dict:
        return {f"stack#{n}": torch.from_numpy(out).to(self.device)
                for n, out in self._sample}

    def close(self) -> None:
        self.stack = self._sample = None


def output_shapes(cfg: dict, mix: dict, inputs: np.ndarray) -> dict:
    return {"stack#1": inputs.shape}


def expected(cfg: dict, mix: dict, inputs: np.ndarray, shapes: dict,
             precision: str, device) -> dict:
    """Every returned stack is the op applied to each image of the
    stack."""
    cols = _cols(mix)
    stack = torch.from_numpy(inputs).to(device)
    outs = [check.single(cols, im, cfg["dtype"], precision)[0]
            for im in stack]
    return {"stack": (torch.stack(outs), None)}
