"""Profiling utilities of the search loop: a wall timer, a generation-rate
meter, and a `torch.profiler` trace of a block (`run_torch.py --profile`).

The reference's only instrumentation is a pretty-printing context Timer
(reference stylegan2/utils.py:69-104); its GA loop has none.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional


class Timer:
    """Context-manager wall timer (reference stylegan2/utils.py:69-104):
    `seconds` holds the block's wall time after it exits."""

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        return False


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
