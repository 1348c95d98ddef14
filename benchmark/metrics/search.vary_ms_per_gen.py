"""search.vary_ms_per_gen: the host's time in the first half of a
generation, in ms: the port's `search.vary` spans (selection, crossover,
mutation and duplicate resampling, one span a search; read from
`clip_glass_torch.core.profiling.TRACER`) whose parent is a `search.step`,
summed within each step, the median over the steps the tracer holds. Most
of them are the timed window's of a `--trace 1` run: set-up's warm-up and
the profiled phase add a few. That window's harness fences each step and
each evaluation with a synchronize, so the spans read fenced host time: a
sync inside them waits for their own device work alone. An unfenced step's
waits on the previous evaluation's device tail show only in the profiled
phase's trace. None where the port records no such span."""

import statistics

SPAN = "search.vary"


def read(ctx):
    try:
        from clip_glass_torch.core.profiling import TRACER
    except ImportError:
        return None
    per_step, ns = [], 0
    for r in TRACER.records():   # in the order the spans ended: children first
        if r.name == SPAN and r.parent == "search.step":
            ns += r.t1_ns - r.t0_ns
        elif r.name == "search.step":
            per_step.append(ns)
            ns = 0
    return statistics.median(per_step) / 1e6 if any(per_step) else None
