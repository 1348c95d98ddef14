"""fitness.host_ms_per_eval: the host's time to issue one generation's
evaluation, in ms: the duration of each of the port's `fitness.eval` spans
(read from `clip_glass_torch.core.profiling.TRACER`) whose parent is a
`search.step`, the median over those the tracer holds. Most of them are the
timed window's of a `--trace 1` run, whose harness fences each evaluation
with a synchronize: the span starts on an idle card and reads fenced host
time. It reads the host clock alone: it ends when the host has issued the
evaluation's last launch, or later where the evaluation itself waits on the
card. The flagship's FIR taps, copied from pageable memory, synchronize the
stream, so there it ends with the card's work and reads about the
evaluation's device time. None where the port records no such span."""

import statistics


def read(ctx):
    try:
        from clip_glass_torch.core.profiling import TRACER
    except ImportError:
        return None
    ns = [r.t1_ns - r.t0_ns for r in TRACER.records()
          if r.name == "fitness.eval" and r.parent == "search.step"]
    return statistics.median(ns) / 1e6 if ns else None
