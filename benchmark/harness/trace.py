"""The benchmark's own instrumentation of the port, from outside it.

`Tap` wraps the two calls every traffic mix drives, a generation's step
and its evaluation, and keeps the window's evaluations (their genomes and
fitness, by reference) for the output check. Where the model family names
a generator output (an image-to-text family's decoded ids,
`GENERATOR_OUTPUT`), `capture` replaces that call of the port for the
window's length and keeps what it returns beside each evaluation, by
reference: no copy and no synchronize. In a traced run it also:

- "timed" phase: fences the step and the evaluation with a synchronize and
  reads the host clock around both (a generation's host time is its wall
  time minus its evaluation's), and puts CUDA events around the port's
  module functions of each layer (`LAYER_FUNCTIONS`, and those the cell's
  model family declares beside them), replaced for the phase only and
  restored after;
- "profiled" phase: a short `torch.profiler` window with CUDA activity only
  (no host-side operator records, which would slow the host), the host
  spans the benchmark was in (to name the device's idle gaps), and the
  operand shapes of each hand-written kernel's call, read where the port
  dispatches it (`ops.cuda.dispatch`).

Nothing of the port is edited: each module attribute is replaced while a
phase runs and put back when it ends.
"""

from __future__ import annotations

import contextlib
import importlib
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch

# (module, function, span): the layers' entry points whose device time the
# timed phase reads, in every cell; the first argument after the weights
# holds the rows. A model family may declare more (benchmark/families/).
LAYER_FUNCTIONS = (
    ("clip_glass_torch.models.stylegan2.model", "generator_apply", "models.G"),
    ("clip_glass_torch.models.biggan.model", "apply", "models.G"),
    ("clip_glass_torch.models.clip.model", "encode_image", "models.CLIP"),
    ("clip_glass_torch.models.stylegan2.model", "discriminator_apply", "models.D"),
)
DISPATCH = ("clip_glass_torch.ops.cuda", "dispatch")


def _kernel_record(name: str, args) -> Optional[tuple]:
    """The operands of a kernel call that yardstick/kernels.py prices."""
    x = args[0]
    if name == "s2d_conv2x2":
        style, demod, pad0 = args[2], args[3], args[4]
        sets = x.shape[0] if (style is not None or demod is not None) else 1
        return (tuple(x.shape), x.element_size(), int(pad0), sets)
    if name == "noise_bias_lrelu":
        return (tuple(x.shape), x.element_size())
    return None


class Tap:
    def __init__(self, device: torch.device, layers: Tuple[Tuple[str, str, str], ...] = ()):
        self.device = device
        # the (module, function, span) entries a traced phase wraps: the
        # harness's own, then the family's `layers`
        self.layers = LAYER_FUNCTIONS + tuple(layers)
        self.mode = "off"            # off | timed | profiled
        self.recording = False
        # (X, F, targets, generator outputs or None) of the window's evaluations
        self.evals: List[Tuple] = []
        self._capturing = False
        self._outputs: Optional[List[torch.Tensor]] = None   # the evaluation's, while capturing
        # timed phase
        self.gens: List[Tuple[float, float]] = []   # (step seconds, its eval seconds)
        self._eval_s = 0.0
        self.events: Dict[str, List] = defaultdict(list)   # span -> [(start, end, rows)]
        # profiled phase
        self.host: List[Tuple[int, int, str]] = []           # (t0 ns, t1 ns, span)
        self.kernel_calls: Dict[str, List[tuple]] = defaultdict(list)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ spans

    @contextlib.contextmanager
    def _host_span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.host.append((t0, time.time_ns(), name))

    def _device_span(self, name: str, rows: int, fn, *a, **k):
        if self.device.type != "cuda":
            return fn(*a, **k)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*a, **k)
        end.record()
        self.events[name].append((start, end, rows))
        return out

    def device_seconds(self, name: str) -> Tuple[float, int]:
        """Summed device seconds and rows of a timed span."""
        got = self.events.get(name, [])
        return (sum(s.elapsed_time(e) for s, e, _ in got) / 1e3, sum(r for _, _, r in got))

    # ------------------------------------------------------------ wraps

    def wrap_step(self, fn: Callable) -> Callable:
        def step(*a, **k):
            if self.mode == "timed":
                self.sync()
                t0 = time.perf_counter()
                self._eval_s = 0.0
                out = fn(*a, **k)
                self.sync()
                self.gens.append((time.perf_counter() - t0, self._eval_s))
                return out
            if self.mode == "profiled":
                with self._host_span("search.step"):
                    return fn(*a, **k)
            return fn(*a, **k)
        return step

    def wrap_eval(self, fn: Callable, targets: Callable,
                  checked: Callable = lambda *a, **k: True) -> Callable:
        """The evaluation, timed or spanned by phase; while recording, each
        evaluation that `checked(X, ...)` admits is kept with `targets()`,
        the target of each of its searches, and the generator outputs
        captured while it ran (None when nothing is captured)."""
        def evaluate(X, *a, **k):
            self._outputs = [] if self._capturing else None
            rows = X.shape[0] * X.shape[1] if X.dim() == 3 else X.shape[0]
            if self.mode == "timed":
                self.sync()
                t0 = time.perf_counter()
                F = self._device_span("fitness.eval", rows, fn, X, *a, **k)
                self.sync()
                self._eval_s += time.perf_counter() - t0
            elif self.mode == "profiled":
                with self._host_span("fitness.eval"):
                    F = fn(X, *a, **k)
            else:
                F = fn(X, *a, **k)
            if self.recording and checked(X, *a, **k):
                self.evals.append((X, F, targets(), self._outputs))
            self._outputs = None
            return F
        return evaluate

    @contextlib.contextmanager
    def capture(self, output: Optional[Tuple[str, str, str]]):
        """Keep, beside each evaluation, what the port's `output` (module,
        class, attribute) returns while it runs, with that attribute
        replaced for the block's length; None captures nothing."""
        if output is None:
            yield
            return
        module_name, owner, attr = output
        obj = getattr(importlib.import_module(module_name), owner)
        original = getattr(obj, attr)

        def kept(*a, **k):
            out = original(*a, **k)
            if self._outputs is not None:
                self._outputs.append(out)
            return out

        setattr(obj, attr, kept)
        self._capturing = True
        try:
            yield
        finally:
            self._capturing = False
            setattr(obj, attr, original)

    @contextlib.contextmanager
    def phase(self, mode: str):
        """Run a traced phase: `mode` "timed" or "profiled", with the
        port's module functions (`self.layers`) replaced for its length."""
        saved = []

        def replace(module_name, attr, wrapper_of):
            module = importlib.import_module(module_name)
            original = getattr(module, attr)
            saved.append((module, attr, original))
            setattr(module, attr, wrapper_of(original))

        for module_name, attr, span in self.layers:
            replace(module_name, attr, lambda f, span=span: self._layer(f, span))
        if mode == "profiled":
            replace(*DISPATCH, self._dispatch)
        self.mode = mode
        try:
            yield
        finally:
            self.mode = "off"
            for module, attr, original in reversed(saved):
                setattr(module, attr, original)

    def _layer(self, fn: Callable, span: str) -> Callable:
        def layer(params, x, *a, **k):
            if self.mode == "timed":
                return self._device_span(span, x.shape[0], fn, params, x, *a, **k)
            with self._host_span(span):
                return fn(params, x, *a, **k)
        return layer

    def _dispatch(self, fn: Callable) -> Callable:
        def dispatch(x, cuda_fn, *rest):
            name = getattr(cuda_fn, "__name__", "").strip("_")
            name = name[:-len("_cuda")] if name.endswith("_cuda") else name
            if isinstance(x, torch.Tensor) and x.is_cuda:
                rec = _kernel_record(name, rest[2:])
                if rec is not None:
                    self.kernel_calls[name].append(rec)
            return fn(x, cuda_fn, *rest)
        return dispatch


def device_timeline(prof) -> List[Tuple[str, int, int]]:
    """(name, start ns, end ns) of every device activity the profiler saw."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    return sorted(out, key=lambda t: t[1])


def busy_intervals(timeline) -> List[Tuple[int, int]]:
    """The union of the activities' intervals, merged."""
    merged: List[List[int]] = []
    for _, s, e in timeline:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(m) for m in merged]


def idle_gaps_by_span(busy, host, t0: int, t1: int) -> Dict[str, float]:
    """Idle seconds between t0 and t1, named by the innermost host span open
    where each gap starts ("host.outside" where none is)."""
    gaps, cursor = [], t0
    for s, e in busy:
        s, e = max(s, t0), min(e, t1)
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if t1 > cursor:
        gaps.append((cursor, t1))
    out: Dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        open_spans = [(h0, h1, n) for h0, h1, n in host if h0 <= g0 < h1]
        name = min(open_spans, key=lambda h: h[1] - h[0])[2] if open_spans else "host.outside"
        out[name] += (g1 - g0) / 1e9
    return dict(out)
