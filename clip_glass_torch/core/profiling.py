"""Profiling: the program's tracer (`TRACER`), a wall timer, a
generation-rate meter, and a `torch.profiler` trace of a block
(`run_torch.py --profile`) written with the tracer's spans.

The tracer records host spans at the port's layer boundaries and integer
counters, in memory, whenever the program runs. A span costs two reads of
the host clock and one append under a lock: no synchronize and no CUDA
event, so on a card it measures the host's time to run and issue a layer's
work. The device side comes from `torch.profiler`, whose kineto events
stamp the same clock (`now_ns`), so the two line up in one trace
(`Tracer.export_chrome`). The spans and where they are opened:

  serve.tick, serve.admit, serve.harvest  serving.SearchServer (tickets)
  search.step                             evolve.algorithm.make_step's step,
                                          evolve.batched.BatchedAlgorithm.step
  search.vary, search.survive             evolve.algorithm.make_step_halves
                                          (search: the index in a batch)
  fitness.eval                            Generator.eval_population(_batched) (rows)
  models.G, models.CLIP, models.D         fitness/generator.py's model calls (rows)
  setup.stage, setup.targets              Generator.__init__, encode_targets (n)
  kernels.load                            ops.cuda.library()'s first build or load (built)
  cli.imports, cli.setup, cli.init,       cli.main's phases
  cli.search, cli.final

and the one counter, kernels.builds: the runs of nvcc (ops.cuda.build).

The reference's only instrumentation is a pretty-printing context Timer and
an EMA value tracker (reference stylegan2/utils.py:69-104, 474-504); its GA
loop has none.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

# records the ring keeps; a 30 s window of the benchmark writes 1,000-3,000
RING = 65536


def now_ns() -> int:
    """The tracer's clock, ns since the epoch: `time.time_ns`, the clock
    torch.profiler's kineto events stamp."""
    return time.time_ns()


class Span(NamedTuple):
    name: str
    t0_ns: int
    t1_ns: int
    parent: Optional[str]   # the innermost span open on the same thread at t0
    attrs: dict


class Total(NamedTuple):
    """A span name's count and summed ns over the process, and its first
    record: kept past the ring's wrap."""
    count: int
    ns: int
    first: Span


class _Open:
    """The context manager of one span; entering gives its attrs, which the
    block may add to."""
    __slots__ = ("_tracer", "_name", "_parent", "_t0", "attrs")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer, self._name, self.attrs = tracer, name, attrs

    def __enter__(self) -> dict:
        stack = self._tracer._stack()
        self._parent = stack[-1] if stack else None
        stack.append(self._name)
        self._t0 = now_ns()
        return self.attrs

    def __exit__(self, *exc) -> bool:
        t1 = now_ns()
        self._tracer._stack().pop()
        self._tracer._record((self._name, self._t0, t1, self._parent, self.attrs))
        return False


class Tracer:
    """Host spans and integer counters of one process, in memory: the last
    `capacity` span records in a ring, and per span name the count, the
    summed ns and the first record. `enabled = False` makes `span` and
    `count` no-ops. Spans nest per thread; every method is thread-safe."""

    def __init__(self, capacity: int = RING):
        self.enabled = True
        self._lock = threading.Lock()
        self._local = threading.local()
        # plain tuples of Span's fields, and [count, ns, first] by name
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._totals: Dict[str, list] = {}
        self._counters: Dict[str, int] = {}

    def span(self, name: str, **attrs):
        """A context manager that records (name, t0, t1, parent, attrs) when
        its block ends, raised or not."""
        if not self.enabled:
            return contextlib.nullcontext(attrs)
        return _Open(self, name, attrs)

    def count(self, name: str, n: int = 1) -> None:
        if self.enabled:
            with self._lock:
                self._counters[name] = self._counters.get(name, 0) + n

    def records(self) -> List[Span]:
        """The ring's records, oldest first, in the order their spans ended
        (a child before its parent)."""
        with self._lock:
            ring = list(self._ring)
        return [Span._make(r) for r in ring]

    def totals(self) -> Dict[str, Total]:
        with self._lock:
            totals = [(name, tuple(t)) for name, t in self._totals.items()]
        return {name: Total(count, ns, Span._make(first)) for name, (count, ns, first) in totals}

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._totals.clear()
            self._counters.clear()

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _record(self, span: tuple) -> None:
        name, t0, t1 = span[:3]
        with self._lock:
            self._ring.append(span)
            t = self._totals.get(name)
            if t is None:
                self._totals[name] = [1, t1 - t0, span]
            else:
                t[0] += 1
                t[1] += t1 - t0

    def export_chrome(self, path: str, prof=None) -> None:
        """Write the ring's spans as a Chrome trace's "X" events on one host
        track, and with `prof`, a finished torch.profiler.profile, every
        activity it recorded: the card's kernels and copies a track per
        stream; the host's a track per thread (operators, or with CUDA
        activity alone the CUDA runtime's calls). Stamps are in us from
        the earliest, `otherData.base_ns` on `now_ns`'s clock."""
        events = [(s.name, s.t0_ns, s.t1_ns - s.t0_ns, 0, 0, {"parent": s.parent, **s.attrs})
                  for s in self.records()]
        if prof is not None:
            import torch

            for e in prof.profiler.kineto_results.events():
                on_card = e.device_type() == torch.autograd.DeviceType.CUDA
                events.append((e.name(), e.start_ns(), e.duration_ns(), 2 if on_card else 1,
                               e.device_resource_id() if on_card else e.start_thread_id(),
                               None))
        base = min((t0 for _, t0, *_ in events), default=0)
        out = [{"name": "process_name", "ph": "M", "pid": pid, "args": {"name": name}}
               for pid, name in enumerate(("program spans", "host activity", "device"))]
        for name, t0, ns, pid, tid, args in events:
            ev = {"name": name, "ph": "X", "pid": pid, "tid": tid, "ts": (t0 - base) / 1e3,
                  "dur": ns / 1e3}
            if args is not None:
                ev["args"] = args
            out.append(ev)
        with open(path, "w") as f:
            json.dump({"traceEvents": out, "otherData": {"base_ns": base}}, f)


# the process's tracer: on whenever the program runs
TRACER = Tracer()


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
def device_trace(logdir: Optional[str], device):
    """`torch.profiler` over the block, written with the tracer's spans as
    one Chrome trace, `<logdir>/trace.json` (`Tracer.export_chrome`); a
    no-op when logdir is falsy. For a run on a card (`device`) it records
    CUDA activity alone: a host record for every operator slows the host and
    widens the device's idle gaps. For a run on the CPU it records CPU
    activity."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        yield
    os.makedirs(logdir, exist_ok=True)
    TRACER.export_chrome(os.path.join(logdir, "trace.json"), prof)
