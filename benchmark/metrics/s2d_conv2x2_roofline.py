"""s2d_conv2x2_roofline: the least time of the kernel's calls in the profiled
window (yardstick/kernels.py: the larger of bytes over the HBM bandwidth and
operations over the unit's peak, from each call's operands) over the device
time of the kernels whose name holds "s2d_conv2x2", in %."""


def read(ctx):
    least = ctx["kernel_least_s"].get("s2d_conv2x2")
    seconds = ctx["kernel_s"].get("s2d_conv2x2")
    return 100.0 * least / seconds if least and seconds else None
