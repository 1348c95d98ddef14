"""Normalization ops.

LayerNorm computes its statistics in fp32 whatever the input dtype, like the
reference's fp16-safe LayerNorm (reference clip/model.py:150-158), and
returns the input's dtype.

`cond_bn_relu` is BigGAN-deep's batch norm with its ReLU, the wrapper of a
hand-written CUDA kernel (csrc/cond_bn_relu.cu): a CUDA tensor launches the
kernel, a CPU tensor takes the plain version (`cond_bn_relu_plain`).
"""

from __future__ import annotations

from typing import Optional

import torch

from clip_glass_torch.core.profiling import TRACER
from clip_glass_torch.ops import cuda
from clip_glass_torch.ops.s2d import tile_channels


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def cond_bn_relu_plain(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                       weight: torch.Tensor, bias: torch.Tensor,
                       b_conv: Optional[torch.Tensor] = None,
                       phases: int = 1) -> torch.Tensor:
    """relu(((x + b_conv) - mean) * rstd * weight + bias), the BigGAN-deep
    batch norm as the JAX package computes it: the conv bias added in x's
    dtype, the normalization in fp32 from the raw fp32 statistics, one
    rounding back to x's dtype. x: [B, H, W, phases * C]; mean, rstd,
    b_conv: [C]; weight, bias: [B, C] per sample or [C] shared. `phases` =
    4 applies it to an s2d tensor (the per-channel vectors tiled across the
    phases)."""
    def tile(t):
        return tile_channels(t, phases) if phases > 1 else t

    if b_conv is not None:
        x = x + tile(b_conv)
    mean, rstd, weight, bias = map(tile, (mean, rstd, weight, bias))
    if weight.dim() == 2:
        weight, bias = weight[:, None, None, :], bias[:, None, None, :]
    y = (x.float() - mean) * rstd
    y = y * weight.float() + bias.float()
    return torch.relu(y.to(x.dtype))


def cond_bn_relu(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                 weight: torch.Tensor, bias: torch.Tensor,
                 b_conv: Optional[torch.Tensor] = None, phases: int = 1) -> torch.Tensor:
    """`cond_bn_relu_plain`'s function. CUDA: the hand-written kernel, one
    pass over x, bitwise the plain version's numbers (x bf16 or fp32 with
    contiguous channels, any b, h and w strides; mean and rstd fp32;
    weight and bias fp32, or bf16 beside bf16 x; b_conv in x's dtype;
    raises on what it does not take), differentiable as its plain version
    (`cuda.with_grad`);
    CPU: `cond_bn_relu_plain`; meta: the kernel's output (`cuda.dispatch`)."""
    return cuda.dispatch(x, _cond_bn_relu_cuda, _cond_bn_relu_meta, cond_bn_relu_plain, x,
                         mean, rstd, weight, bias, b_conv, phases)


def _cond_bn_relu_meta(x, mean, rstd, weight, bias, b_conv, phases) -> torch.Tensor:
    """The kernel's shape rule: a dense tensor of x's shape and dtype."""
    return x.new_empty(x.shape)


def _cond_bn_relu_check(x, mean, rstd, weight, bias, b_conv, phases) -> None:
    """Raise on operands that the kernel does not take."""
    B, C = x.shape[0], mean.shape[-1]
    if (x.dim() != 4 or x.shape[-1] != phases * C or mean.shape != (C,)
            or rstd.shape != (C,) or weight.shape != bias.shape
            or weight.shape not in ((C,), (B, C))
            or (b_conv is not None and b_conv.shape != (C,))):
        shapes = [None if t is None else tuple(t.shape)
                  for t in (x, mean, rstd, weight, bias, b_conv)]
        raise ValueError(f"cond_bn_relu: shapes of x, mean, rstd, weight, bias, b_conv "
                         f"{shapes}, phases {phases}")
    if x.dtype not in cuda.DTYPE_CODES:
        raise TypeError(f"cond_bn_relu: x of dtype {x.dtype} (float32 or bfloat16)")
    if x.dtype == torch.float32 and weight.dtype != torch.float32:
        raise TypeError(f"cond_bn_relu: fp32 x with a {weight.dtype} affine (fp32)")
    cuda.require_cuda("cond_bn_relu", mean, rstd, dtype=torch.float32)
    cuda.require_cuda("cond_bn_relu", weight, bias, dtype=weight.dtype)
    if b_conv is not None:
        cuda.require_cuda("cond_bn_relu", b_conv, dtype=x.dtype)
    if any(t.device != x.device for t in (mean, weight, b_conv) if t is not None):
        raise ValueError(f"cond_bn_relu: x on {x.device}, mean on {mean.device}, "
                         f"weight on {weight.device}")


def _cond_bn_relu_cuda(x, mean, rstd, weight, bias, b_conv, phases) -> torch.Tensor:
    """Check the operands and launch the kernel: x as the convs hand it over
    (a copy only where its channels are not contiguous), the output
    dense; counts the launch in `cond_bn_relu.launches` and the tracer's
    `kernels.cond_bn`."""
    global _cond_bn_entry
    _cond_bn_relu_check(x, mean, rstd, weight, bias, b_conv, phases)
    if x.stride(-1) != 1:
        x = x.contiguous()
    B, H, W, Cx = x.shape
    C = mean.shape[0]
    # strides of dims of extent 1 are never stepped
    strides = [s if n > 1 else 0 for s, n in zip(x.stride()[:3], x.shape[:3])]
    vec = 16 // x.element_size()
    if C % vec or x.data_ptr() % 16 or any(s % vec for s in strides):
        vec = 1
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if _cond_bn_entry is None:
        _cond_bn_entry = cuda.library().cg_cond_bn_relu
    with cuda.launch_device(x):
        status = _cond_bn_entry(
            x.data_ptr(), None if b_conv is None else b_conv.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(), B, H, W, Cx,
            C, *strides, C if weight.dim() == 2 else 0,
            cuda.DTYPE_CODES[x.dtype], cuda.DTYPE_CODES[weight.dtype], vec,
            cuda.stream_handle(x))
    if status:
        cuda.check(status, "cond_bn_relu")
    cond_bn_relu.launches += 1
    cond_bn_relu.launches_by_variant["vector" if vec > 1 else "scalar"] += 1
    TRACER.count("kernels.cond_bn")
    return out


_cond_bn_entry = None  # the bound C function, at first CUDA use
cond_bn_relu.launches = 0
cond_bn_relu.launches_by_variant = {"vector": 0, "scalar": 0}
