"""device.peak_mem_gib: torch.cuda.max_memory_allocated over the window,
the peak statistics reset at its start, in GiB."""


def read(ctx):
    return ctx["mem_peak"] / 2 ** 30 if ctx["mem_peak"] else None
