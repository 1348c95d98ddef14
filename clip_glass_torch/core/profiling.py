"""Profiling utilities: a wall timer, an EMA tracker of scalar streams, a
generation-rate meter, a progress line, and a `torch.profiler` trace of a
block (`run_torch.py --profile`).

The reference's only instrumentation is a pretty-printing context Timer and
an EMA ValueTracker (reference stylegan2/utils.py:69-104, 474-504); its GA
loop has none.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Dict, Optional


class Timer:
    """Context-manager wall timer (reference stylegan2/utils.py:69-104):
    `seconds` holds the block's wall time after it exits."""

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        return False


class ValueTracker:
    """EMA tracker of scalar streams (reference stylegan2/utils.py:474-504)."""

    def __init__(self, beta: float = 0.95):
        self.beta = beta
        self._values: Dict[str, float] = {}
        self._raw: Dict[str, float] = {}

    def add(self, name: str, value: float):
        value = float(value)
        self._raw[name] = value
        if name in self._values:
            self._values[name] = self.beta * self._values[name] + (1 - self.beta) * value
        else:
            self._values[name] = value

    def value(self, name: str) -> float:
        return self._values[name]

    def raw(self, name: str) -> float:
        return self._raw[name]

    def names(self):
        return sorted(self._values)

    def format(self) -> str:
        return "  ".join(f"{k}={self._values[k]:.4g}" for k in self.names())


class GenerationMeter:
    """Search-loop rate meter: generations/sec and candidates/sec."""

    def __init__(self, pop_size: int):
        self.pop_size = pop_size
        self.rebaseline(0)

    @property
    def generation(self) -> int:
        """Current absolute generation counter."""
        return self._gens

    def rebaseline(self, gen: int):
        """Restart the clock at absolute generation `gen`: subsequent rates
        measure only work done after this call. Use after any wall-clock
        block that is not search work (kernel builds, checkpoint load)."""
        self._t0 = time.perf_counter()
        self._base = int(gen)
        self._gens = int(gen)

    def set_generation(self, gen: int, rebaseline: bool = False):
        """Pin the absolute generation counter (resumed searches learn it
        from the GA state); rebaseline=True also restarts the clock."""
        if rebaseline:
            self.rebaseline(gen)
        else:
            self._gens = int(gen)

    @property
    def gens_per_sec(self) -> float:
        dt = time.perf_counter() - self._t0
        return (self._gens - self._base) / dt if dt > 0 else 0.0

    @property
    def candidates_per_sec(self) -> float:
        return self.gens_per_sec * self.pop_size


class ProgressWriter:
    """Minimal progress reporter (reference stylegan2/utils.py:536-633 wraps
    tqdm/notebook displays): carriage-return progress lines on a stream,
    stdout by default."""

    def __init__(self, total: int, label: str = "", stream=None):
        self.total = total
        self.label = label
        self.n = 0
        self._stream = stream or sys.stdout
        self._t0 = time.perf_counter()

    def update(self, n: int = 1, **values):
        self.n += n
        dt = time.perf_counter() - self._t0
        rate = self.n / dt if dt > 0 else 0.0
        extra = "  ".join(f"{k}={v:.4g}" for k, v in values.items())
        pct = 100.0 * self.n / max(self.total, 1)
        self._stream.write(
            f"\r{self.label} {self.n}/{self.total} ({pct:.0f}%) "
            f"{rate:.2f} it/s  {extra}")
        self._stream.flush()
        if self.n >= self.total:
            self._stream.write("\n")

    def close(self):
        if self.n < self.total:
            self._stream.write("\n")


@contextlib.contextmanager
def device_trace(logdir: Optional[str]):
    """`torch.profiler` over the block (the CPU, and the card when there is
    one), written as a Chrome trace to `<logdir>/trace.json`; a no-op when
    logdir is falsy."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
