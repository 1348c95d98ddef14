"""device.idle_share: 1 - the union of the device activities' intervals
over the profiled window's length (torch.profiler, CUDA activity only)."""


def read(ctx):
    return 1.0 - ctx["busy_s"] / ctx["window_s"] if ctx.get("window_s") else None
