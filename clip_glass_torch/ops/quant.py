"""Opt-in int8 quantized execution of the frozen models' convolutions.

The JAX package's ops/quant.py, on the port's layouts:

- Weights: per-output-channel symmetric int8, sw[o] = absmax * float32(1/127)
  over every axis but O, from the kernel the float path would use (already rounded to
  the compute dtype); quantized by dividing by sw, rounding half to even and
  clipping to +-127.
- Activations: one static scale per call site, calibrated once from one
  evaluation in the float path (`calibration`), times the config's margin;
  quantized by multiplying with float32(127/sx), rounding and clipping (out
  of range values saturate): inside `conv_s8`, in its gather on the card.
- Accumulation in int32 (`ops/conv_s8.py`: the hand-written kernel on the
  card), dequantized in the conv's epilogue by float32(acc) * scale[o],
  rounded once to the activation dtype. scale = sw * float32(sx/127) as the
  JAX package's compiled program forms it: absmax[o] * float32(float32(1/127)
  * float32(sx/127)) (XLA folds the two constants first).

Call sites: every `ops.modulated_conv._conv` call whose weight has
min(in_ch, out_ch) >= min_ch, matched to its scale by call order. The
ambient context is per thread (`threading.local`): the scope that
`fitness.generator` enters around one batch evaluation covers that thread's
convs only, so a render on another thread (the CLI's saver, the server's
caller) stays in the float path. The port runs eagerly, so the generator
enters a fresh scope for every batch it evaluates, and each evaluation
consumes the scales from the first again, as each JAX trace does.

A scale that is not finite or not positive (a dead activation at
calibration) keeps its site in the float path, and still uses up its index.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

import numpy as np
import torch

INT8_MODES = ("int8",)
_INV127 = np.float32(1.0 / 127.0)


class _Ctx:
    __slots__ = ("mode", "min_ch", "records", "scales", "i")

    def __init__(self, mode: str, min_ch: int, scales: Optional[np.ndarray] = None):
        self.mode = mode            # "calib" | "int8"
        self.min_ch = min_ch
        self.records = []           # calib: absmax 0-d tensors, call order
        self.scales = scales        # int8: host floats, same order
        self.i = 0


_local = threading.local()


def _current() -> Optional[_Ctx]:
    return getattr(_local, "ctx", None)


def eligible(w_shape, min_ch: int) -> bool:
    """Quantize a conv whose in and out channel counts are both >= min_ch.
    `w_shape`: the port's OIHW [O, I, kh, kw]. Shapes alone decide, so the
    calibration and every evaluation enumerate the same call sites."""
    out_ch, in_ch = w_shape[0], w_shape[1]
    return min(in_ch, out_ch) >= min_ch


def hooked(w_shape) -> bool:
    """Whether a conv of OIHW weight shape `w_shape` on this thread is a call
    site of an active calibration or int8 scope."""
    ctx = _current()
    return ctx is not None and eligible(w_shape, ctx.min_ch)


@contextlib.contextmanager
def _scope(ctx: _Ctx):
    prev = _current()
    _local.ctx = ctx
    try:
        yield ctx
    finally:
        _local.ctx = prev


@contextlib.contextmanager
def calibration(min_ch: int = 64):
    """Recording mode: every eligible conv appends the absmax of its input
    (a 0-d fp32 tensor on its device) to the yielded list and runs in the
    float path."""
    with _scope(_Ctx("calib", min_ch)) as ctx:
        yield ctx.records


@contextlib.contextmanager
def int8_scope(scales, min_ch: int = 64):
    """Execution mode: eligible convs consume the calibrated activation
    scales in call order and run as int8 convs."""
    with _scope(_Ctx("int8", min_ch, np.asarray(scales, np.float64))):
        yield


def quantize_weights(w: torch.Tensor):
    """OIHW weights -> (int8 weights, fp32 per-output-channel absmax, at
    least 1e-30). The weight scale is sw = absmax * float32(1/127), as the
    JAX package's compiled program computes absmax/127 (XLA turns the
    division by the constant into that product); the weights are divided by
    sw."""
    w32 = w.float()
    wmax = w32.abs().amax(dim=(1, 2, 3)).clamp_min(1e-30)
    sw = wmax * float(_INV127)
    wq = torch.round(w32 / sw[:, None, None, None]).clamp_(-127, 127).to(torch.int8)
    return wq, wmax


def activation_inv_scale(sx: float) -> float:
    """float32(127/sx): the factor that quantizes an activation of static
    scale sx."""
    return float(np.float32(127.0 / sx))


def conv_hook(x: torch.Tensor, w: torch.Tensor, run):
    """The one integration point, called by ops.modulated_conv._conv with
    `run(x, ww, scale, x_inv_scale)`: scale None runs the float conv of x
    and ww; an fp32 [O] scale runs the int8 conv of x, quantized by
    x_inv_scale = float32(127/sx) (inside conv_s8, in its gather on the
    card), and int8 ww, dequantized by scale to x's dtype. With no scope on
    this thread: `run(x, w, None, None)`."""
    ctx = _current()
    if ctx is None or not eligible(w.shape, ctx.min_ch):
        return run(x, w, None, None)
    if ctx.mode == "calib":
        ctx.records.append(x.float().abs().amax())
        return run(x, w, None, None)
    if ctx.scales is None or ctx.i >= len(ctx.scales):
        raise RuntimeError(
            f"int8_scope: conv call #{ctx.i} has no calibrated scale "
            f"({0 if ctx.scales is None else len(ctx.scales)} recorded): the "
            "calibration and this evaluation took different paths")
    sx = float(ctx.scales[ctx.i])
    ctx.i += 1
    if not math.isfinite(sx) or sx <= 0.0:
        return run(x, w, None, None)  # dead activation at calibration: keep float
    wq, wmax = quantize_weights(w)
    # sw * float32(sx/127) with XLA's association: its two float32 constants
    # folded into one product first
    scale = wmax * float(_INV127 * np.float32(sx / 127.0))
    return run(x, wq, scale, activation_inv_scale(sx))
