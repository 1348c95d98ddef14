"""The int8 convolution of the quantized fitness (ops/quant.py).

`conv_s8(xq, wq, scale, ...)`: int8 activations [B, H, W, I] (NHWC) against
int8 weights [O, I, kh, kw] (OIHW, the port's `_conv` layout), summed in
int32, each output dequantized as float32(acc) * scale[o] and rounded once
to `out_dtype` (bf16 or fp32; int32 returns the accumulators). The geometry
is `_conv`'s: the input dilated by `lhs_dilation`, padded by pad0 before and
pad1 after on both spatial axes (negative crops), then correlated with
stride `stride`.

A CUDA tensor launches the hand-written kernel (csrc/conv_s8.cu, an
implicit GEMM on mma.sync int8 tensor cores); a CPU tensor takes
`conv_s8_plain`, the same function computed exactly by a float64 conv of the
int8 values (127^2 * K < 2^53 for every K the models have, so every partial
sum is exact). The JAX package leaves this conv to XLA
(clip_glass_tpu/ops/quant.py:137); PyTorch has no int8 conv on CUDA, so no
TPU kernel is ported here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from clip_glass_torch.ops import cuda

# output dtype codes of csrc/conv_s8.cu
OUT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
K_TILE = 64  # the kernel's K step: the packed weight rows are padded to it


def out_size(n: int, k: int, stride: int, pad0: int, pad1: int, lhs_dilation: int) -> int:
    """Output extent of one spatial axis."""
    return ((n - 1) * lhs_dilation + 1 + pad0 + pad1 - k) // stride + 1


def conv_s8_plain(xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, *, stride=1,
                  pad0=0, pad1=0, lhs_dilation=1, out_dtype=torch.float32) -> torch.Tensor:
    """The exact int8 conv: the dilated, padded input gathered once per tap
    and multiplied in float64 (integer-valued, so exact in any order), the
    sum converted to int32, then float32(acc) * scale[o] rounded once to
    out_dtype (int32: the sum itself)."""
    B, H, W, I = xq.shape
    O, _, kh, kw = wq.shape
    d = lhs_dilation
    x = xq.double()
    if d > 1:
        xd = x.new_zeros((B, (H - 1) * d + 1, (W - 1) * d + 1, I))
        xd[:, ::d, ::d] = x
        x = xd
    x = F.pad(x, (0, 0, pad0, pad1, pad0, pad1))
    Ho = (x.shape[1] - kh) // stride + 1
    Wo = (x.shape[2] - kw) // stride + 1
    wd = wq.double()
    acc = None
    for ky in range(kh):
        for kx in range(kw):
            xs = x[:, ky:ky + stride * (Ho - 1) + 1:stride, kx:kx + stride * (Wo - 1) + 1:stride]
            t = xs @ wd[:, :, ky, kx].t()
            acc = t if acc is None else acc.add_(t)
    acc = acc.to(torch.int32)
    return acc if out_dtype == torch.int32 else (acc.float() * scale).to(out_dtype)


def pack_weights(wq: torch.Tensor) -> torch.Tensor:
    """OIHW int8 -> the kernel's [O, ldw] rows: (ky, kx, i) order, zero past
    K = kh*kw*I up to ldw, the next multiple of K_TILE."""
    O, I, kh, kw = wq.shape
    K = kh * kw * I
    ldw = -(-K // K_TILE) * K_TILE
    packed = wq.new_zeros((O, ldw))
    packed[:, :K] = wq.permute(0, 2, 3, 1).reshape(O, K)
    return packed


def conv_s8(xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, *, stride=1, pad0=0,
            pad1=0, lhs_dilation=1, out_dtype=torch.float32) -> torch.Tensor:
    """[B, Ho, Wo, O] of `conv_s8_plain`'s function. CUDA: the hand-written
    kernel (raises on what it does not take, or if it does not build); CPU:
    `conv_s8_plain`."""
    if xq.device.type == "cpu":
        return conv_s8_plain(xq, wq, scale, stride=stride, pad0=pad0, pad1=pad1,
                             lhs_dilation=lhs_dilation, out_dtype=out_dtype)
    B, H, W, I = xq.shape
    O, Iw, kh, kw = wq.shape
    if xq.device.type != "cuda" or any(t.device != xq.device for t in (wq, scale)):
        raise ValueError(f"conv_s8: tensors on {xq.device}, {wq.device}, {scale.device}; "
                         "all must be on one CUDA device")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"conv_s8: expected int8, int8, float32; got {xq.dtype}, "
                        f"{wq.dtype}, {scale.dtype}")
    if out_dtype not in OUT_CODES:
        raise TypeError(f"conv_s8: out_dtype {out_dtype} (float32, bfloat16 or int32)")
    if Iw != I or tuple(scale.shape) != (O,) or stride < 1 or lhs_dilation < 1:
        raise ValueError(f"conv_s8: x {tuple(xq.shape)}, w {tuple(wq.shape)}, scale "
                         f"{tuple(scale.shape)}, stride {stride}, lhs_dilation {lhs_dilation}")
    Ho = out_size(H, kh, stride, pad0, pad1, lhs_dilation)
    Wo = out_size(W, kw, stride, pad0, pad1, lhs_dilation)
    if Ho < 1 or Wo < 1:
        raise ValueError(f"conv_s8: empty output {Ho}x{Wo}")
    xq, scale = xq.contiguous(), scale.contiguous()
    packed = pack_weights(wq)
    out = torch.empty((B, Ho, Wo, O), dtype=out_dtype, device=xq.device)
    vec16 = int(I % 16 == 0 and xq.data_ptr() % 16 == 0)
    status = cuda.library().cg_conv_s8(
        xq.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(), B, H, W, I, Ho,
        Wo, O, kh, kw, packed.shape[1], stride, pad0, lhs_dilation, OUT_CODES[out_dtype],
        vec16, cuda.stream_handle(xq))
    cuda.check(status, "conv_s8")
    conv_s8.launches += 1
    return out


conv_s8.launches = 0
