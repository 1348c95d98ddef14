"""Operations and bytes of one call of each hand-written kernel, from its
shapes, and the least time the card could take for them: the larger of
bytes over the HBM bandwidth and operations over the unit's peak. Each
input byte counts once as read and each output byte once as written, as
`chip_smoke.py`'s bound arithmetic counts them.

A call is described by what the kernel's wrapper is handed: the kernel's
name and its operands' shapes and element sizes (`harness/trace.py`
records them in the traced window).
"""

from __future__ import annotations

import math

from benchmark.yardstick import peaks


def s2d_conv2x2(x_shape, itemsize: int, pad0: int, weight_sets: int):
    """Kernel 4: the [2,2] conv between opposite s2d lattices. x [B, n, n,
    C'], one folded weight set [2, 2, C', C'] a sample (modulated) or one
    for all (`weight_sets` 1); out [B, n +- 1, n +- 1, C']. Operations: 2
    per multiply-add, on the bf16 tensor cores for bf16."""
    B, n, _, C = x_shape
    n_out = n + 1 if pad0 else n - 1
    n_bytes = itemsize * (B * n * n * C + weight_sets * 4 * C * C + B * n_out * n_out * C)
    ops = 2 * B * n_out * n_out * 4 * C * C
    peak = peaks.BF16_FLOPS[-1][1] if itemsize == 2 else peaks.FP32_FLOPS
    return n_bytes, ops, peak


def noise_bias_lrelu(x_shape, itemsize: int):
    """Kernel 1: the synthesis epilogue, lrelu(x + s * noise[h, w] + b[c]) *
    gain on x [B, H, W, C]: x, the noise plane, the scale and the bias read,
    the output written; 5 operations a value, in fp32 on the CUDA cores."""
    B, H, W, C = x_shape
    numel = math.prod(x_shape)
    n_bytes = itemsize * (2 * numel + H * W + 1 + C)
    return n_bytes, 5 * numel, peaks.FP32_FLOPS


def least_seconds(n_bytes: int, ops: int, peak: float) -> float:
    return max(n_bytes / peaks.HBM_BYTES_PER_S, ops / peak)


COSTS = {"s2d_conv2x2": s2d_conv2x2, "noise_bias_lrelu": noise_bias_lrelu}
