"""setup.first_eval_s: the seconds of the process's first evaluation, the
port's first `fitness.eval` span (read from
`clip_glass_torch.core.profiling.TRACER`, which keeps each span's first
record): it holds the kernel library's build or load (`kernels.load`),
cuDNN's first calls and CUDA's lazy loading of the kernels it runs. None
where the port records no such span."""


def read(ctx):
    try:
        from clip_glass_torch.core.profiling import TRACER
    except ImportError:
        return None
    total = TRACER.totals().get("fitness.eval")
    return (total.first.t1_ns - total.first.t0_ns) / 1e9 if total else None
