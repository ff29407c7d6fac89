"""What every traffic driver shares: the measured window, the traced
sub-window and the benchmark's own host spans.

A traffic mix (``dipbench/mixes/<mix>.json``) is a file of parameters
whose ``"driver"`` names the module that drives the port with them,
``dipbench/drivers/<driver>.py``, found by that name. A new kind of
traffic is a new driver file; a new mix of a known kind, a data file.
A driver module holds:

- ``make_inputs(cfg, mix, seed, device, size=None)``: the host inputs,
  made on ``device`` from ``seed`` (``size`` (H, W) replaces the
  configuration's image size, for tests on the CPU);
- ``Driver(cfg, mix, inputs, seed, device, spans)``: ``names`` (the
  rounds' kinds, cycled in order), ``step(i)`` (one round of kind
  ``i``), ``items(rounds)`` (the work those rounds did), ``outputs()``
  (after the window: what the check judges, by name, as tensors on the
  device) and ``close()``;
- ``output_shapes(cfg, mix, inputs)``: the names and shapes of the
  outputs a run judges, without running the program (for the control);
- ``expected(cfg, mix, inputs, shapes, precision, device)``: the plain
  reference's output of each name in ``shapes``, with its don't-care
  mask or None (``dipbench/check.py``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch


@dataclass
class Window:
    """What one measured window did."""
    seconds: float
    rounds: int
    items: int          # applications (rounds x k) or images


@dataclass
class Spans:
    """The benchmark's own host spans around the calls into the port:
    nanoseconds summed and calls counted, while ``on``."""
    on: bool = False
    enqueue_ns: int = 0
    enqueue_calls: int = 0

    def wrap(self, fn):
        def timed(x):
            if not self.on:
                return fn(x)
            t0 = time.perf_counter_ns()
            out = fn(x)
            self.enqueue_ns += time.perf_counter_ns() - t0
            self.enqueue_calls += 1
            return out
        return timed


def warm(driver, cycles: int) -> None:
    """Run every kind of round ``cycles`` times: the first runs load the
    kernels and capture the CUDA graphs, which is set-up."""
    for _ in range(cycles):
        for i in range(len(driver.names)):
            driver.step(i)


def measure(driver, seconds: float) -> tuple[float, Window]:
    """Whole cycles of the rounds until ``seconds`` have passed; the window
    ends with the round that completes the cycle crossing the deadline.
    Returns the host clock at the first timed round and the window."""
    n = len(driver.names)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    rounds = 0
    while True:
        for i in range(n):
            driver.step(i)
        rounds += n
        if time.perf_counter() >= deadline:
            break
    length = time.perf_counter() - t0
    return t0, Window(length, rounds, driver.items(rounds))


def traced(driver, rounds: int, path: str) -> None:
    """``rounds`` rounds under ``torch.profiler`` (host and CUDA activity,
    no Python tracing), marked for ``trace.summarize``; the Chrome trace
    is written to ``path``."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    n = len(driver.names)
    with profile(activities=acts) as prof:
        # One cycle before the sub-window: the profiler's first rounds
        # pay its own start-up.
        warm(driver, 1)
        with record_function("dipbench.window"):
            for j in range(rounds):
                i = j % n
                with record_function("round:" + driver.names[i]):
                    driver.step(i)
    prof.export_chrome_trace(path)
