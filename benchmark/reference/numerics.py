"""The reference's arithmetic: float32 with TF32 off; and, for the output
check's control, the same computation in fp8, the precision below the
configurations' bf16: every matmul and conv operand and every layer's
output rounded to e4m3 (one scale a tensor: its largest magnitude maps to
448), the rest in float32. "bf16" rounds the same values to bf16, for the
readings that place the limits."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

_MODE = {"precision": "fp32"}
E4M3_MAX = 448.0


@contextlib.contextmanager
def fp32_exact(precision: str = "fp32"):
    """TF32 off for cuBLAS and cuDNN inside the block, as it was after;
    `precision` "bf16" or "fp8" rounds every matmul and conv operand and
    every layer's output (`rounded`) to bf16 or to e4m3."""
    if precision not in ("fp32", "bf16", "fp8"):
        raise ValueError(f"unknown precision {precision!r}")
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision(), _MODE["precision"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    _MODE["precision"] = precision
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])
        _MODE["precision"] = saved[3]


def rounded(t: torch.Tensor) -> torch.Tensor:
    """t as the precision holds a matmul or conv operand or a layer's
    output: itself in float32, else rounded to bf16 or to e4m3."""
    if _MODE["precision"] == "fp32":
        return t
    if _MODE["precision"] == "bf16":
        return t.to(torch.bfloat16).to(t.dtype)
    scale = t.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return rounded(a) @ rounded(b)


def conv2d(x, w, **kw):
    return F.conv2d(rounded(x), rounded(w), **kw)


def conv_transpose2d(x, w, **kw):
    return F.conv_transpose2d(rounded(x), rounded(w), **kw)
