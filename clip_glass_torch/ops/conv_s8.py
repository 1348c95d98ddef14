"""The int8 convolution of the quantized fitness (ops/quant.py).

`conv_s8(x, wq, scale, ...)`: activations [B, H, W, I] (NHWC) against int8
weights [O, I, kh, kw] (OIHW, the port's `_conv` layout), summed in int32,
each output dequantized as float32(acc) * scale[o] and rounded once to
`out_dtype` (bf16 or fp32; int32 returns the accumulators). x is int8, or
float (bf16 or fp32) with `x_inv_scale` = float32(127/sx): the kernel then
quantizes it as it gathers it, round(x * x_inv_scale) half to even, clipped
to +-127, the arithmetic of `quantize` and of the JAX package's
`clip(round(x * (127/sx)))`. The geometry is
`_conv`'s: the input dilated by `lhs_dilation`, padded by pad0 before and
pad1 after on both spatial axes (negative crops), then correlated with
stride `stride`. Inference only: with grad mode on, an input that requires
grad raises.

A CUDA tensor launches the hand-written kernel (csrc/conv_s8.cu), on the
route `conv_s8_variant` picks: "wgmma" (wgmma s8, the weights by TMA, a
float x quantized in the gather, a 2-dilated conv split by output phase so
that no product falls on a dilation hole) or "mma_sync" (the first design,
on int8 x: a float x is quantized by `quantize` first). A
CPU tensor takes `conv_s8_plain`, the same function computed exactly by a
float64 conv of the int8 values (127^2 * K < 2^53 for every K the models
have, so every partial sum is exact). The JAX package leaves this conv to
XLA (clip_glass_tpu/ops/quant.py:137); PyTorch has no int8 conv on CUDA, so
no TPU kernel is ported here.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from clip_glass_torch.ops import cuda

# output and input dtype codes of csrc/conv_s8.cu
OUT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
X_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
K_TILE = 128  # the wgmma route's K step: the packed weight rows are padded to it


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


def conv_s8_variant(I: int, stride: int, lhs_dilation: int) -> str:
    """The kernel route of a conv_s8 call, from its shapes alone: "wgmma"
    where 16 input channels are one 16-byte gather (I % 16 == 0) and the
    conv is undilated or 2-dilated at stride 1 (its output phases): 41 of
    the int8 flagship's 42 sites; "mma_sync", the first design, elsewhere:
    D's last conv (I = 513, the minibatch-std channel) and odd widths."""
    if I % 16 == 0 and (lhs_dilation == 1 or (lhs_dilation == 2 and stride == 1)):
        return "wgmma"
    return "mma_sync"


def phases(kh: int, kw: int, stride: int, pad0: int, lhs_dilation: int, Ho: int,
           Wo: int) -> list:
    """The output phases of the conv, each a conv of the undilated input:
    (ky0, kx0, kh', kw', pad_y, pad_x, Ho', Wo', oy0, ox0): its taps are
    ky0, ky0 + d, ... (kh' of them; the same for columns), its input row
    u * stride + j - pad_y for compacted tap j, its outputs rows oy0 + d * u.
    Undilated (d = 1): the conv itself. d = 2 at stride 1: the four phases
    (oy mod 2, ox mod 2); output row oy = 2u + r reads dilated row oy + ky -
    pad0, a real sample iff r + ky - pad0 is even, which is input row u +
    (r + ky - pad0) / 2. Phases with no output are left out; one whose
    parity meets no tap (k = 1) keeps kh' = 0 and writes zeros."""
    if lhs_dilation == 1:
        return [(0, 0, kh, kw, pad0, pad0, Ho, Wo, 0, 0)]
    if lhs_dilation != 2 or stride != 1:
        raise ValueError(f"conv_s8: no phase split at stride {stride}, lhs_dilation "
                         f"{lhs_dilation}")
    out = []
    for ry in (0, 1):
        ky0 = (pad0 - ry) % 2
        for rx in (0, 1):
            kx0 = (pad0 - rx) % 2
            Hp, Wp = (Ho - ry + 1) // 2, (Wo - rx + 1) // 2
            if Hp > 0 and Wp > 0:
                out.append((ky0, kx0, len(range(ky0, kh, 2)), len(range(kx0, kw, 2)),
                            (pad0 - ry - ky0) // 2, (pad0 - rx - kx0) // 2, Hp, Wp, ry, rx))
    return out


def pack_weights(wq: torch.Tensor, phase_list=None, lhs_dilation: int = 1) -> torch.Tensor:
    """OIHW int8 -> the kernel's [n_phases, O, ldw]: phase q's rows the
    weights of its taps (`phases`; every tap by default) in (ky, kx, i)
    order, zero past its K = kh' * kw' * I, with ldw the largest K rounded up
    to a multiple of K_TILE."""
    O, I, kh, kw = wq.shape
    if phase_list is None:
        phase_list = [(0, 0, kh, kw)]
    d = lhs_dilation
    ldw = max(K_TILE, -(-max(p[2] * p[3] * I for p in phase_list) // K_TILE) * K_TILE)
    packed = wq.new_zeros((len(phase_list), O, ldw))
    for q, (ky0, kx0, khp, kwp, *_) in enumerate(phase_list):
        K = khp * kwp * I
        if K:
            taps = wq[:, :, ky0::d, kx0::d]
            packed[q, :, :K] = taps.permute(0, 2, 3, 1).reshape(O, K)
    return packed


def conv_s8_phases_plain(xq: torch.Tensor, packed: torch.Tensor, phase_list, *, stride: int,
                         lhs_dilation: int, Ho: int, Wo: int) -> torch.Tensor:
    """The int32 accumulators of the conv as the wgmma route computes them,
    in plain PyTorch (float64, exact): for each phase of `phases`, the
    undilated input gathered per compacted tap (zeros outside it) times its
    packed weights, written to the phase's output rows."""
    B, H, W, I = xq.shape
    O = packed.shape[1]
    d = 1 if lhs_dilation == 1 else 2
    x = xq.double()
    acc = torch.zeros((B, Ho, Wo, O), dtype=torch.float64)
    for q, (_, _, khp, kwp, pad_y, pad_x, Hp, Wp, oy0, ox0) in enumerate(phase_list):
        w = packed[q].double()
        part = torch.zeros((B, Hp, Wp, O), dtype=torch.float64)
        for jy in range(khp):
            rows = torch.arange(Hp) * stride + jy - pad_y
            for jx in range(kwp):
                cols = torch.arange(Wp) * stride + jx - pad_x
                ok = (((rows >= 0) & (rows < H))[:, None] & ((cols >= 0) & (cols < W))[None])
                g = x[:, rows.clamp(0, H - 1)][:, :, cols.clamp(0, W - 1)] * ok[None, :, :, None]
                k0 = (jy * kwp + jx) * I
                part += g @ w[:, k0:k0 + I].t()
        acc[:, oy0::d, ox0::d] = part
    return acc.to(torch.int32)


def conv_s8(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, *, stride=1, pad0=0,
            pad1=0, lhs_dilation=1, out_dtype=torch.float32,
            x_inv_scale: float = None) -> torch.Tensor:
    """[B, Ho, Wo, O] of `conv_s8_plain`'s function on x, or on x quantized
    by `x_inv_scale` when it is float. CUDA: the hand-written kernel on the
    route `conv_s8_variant` picks (raises on what it does not take, or if it
    does not build); CPU: `conv_s8_plain`. Raises when a gradient is wanted
    (`cuda.grad_wanted`): the int8 conv has none."""
    if x.dtype == torch.int8:
        if x_inv_scale is not None:
            raise TypeError("conv_s8: x_inv_scale given with an int8 x")
    elif x.dtype not in (torch.float32, torch.bfloat16) or x_inv_scale is None:
        raise TypeError(f"conv_s8: x must be int8, or float32 / bfloat16 with "
                        f"x_inv_scale; got {x.dtype}, x_inv_scale {x_inv_scale}")
    if cuda.grad_wanted(x, scale):
        raise RuntimeError("conv_s8 is inference-only: an input requires grad with "
                           "grad mode on (use torch.no_grad() or torch.inference_mode())")
    geometry = dict(stride=stride, pad0=pad0, pad1=pad1, lhs_dilation=lhs_dilation)
    if cuda.takes_plain(x):
        xq = x if x_inv_scale is None else quantize(x, x_inv_scale)
        return conv_s8_plain(xq, wq, scale, out_dtype=out_dtype, **geometry)
    B, H, W, I = x.shape
    O, Iw, kh, kw = wq.shape
    if x.device.type != "cuda" or any(t.device != x.device for t in (wq, scale)):
        raise ValueError(f"conv_s8: tensors on {x.device}, {wq.device}, {scale.device}; "
                         "all must be on one CUDA device")
    if wq.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"conv_s8: expected int8 weights and float32 scales; got "
                        f"{wq.dtype}, {scale.dtype}")
    if out_dtype not in OUT_CODES:
        raise TypeError(f"conv_s8: out_dtype {out_dtype} (float32, bfloat16 or int32)")
    if Iw != I or tuple(scale.shape) != (O,) or stride < 1 or lhs_dilation < 1:
        raise ValueError(f"conv_s8: x {tuple(x.shape)}, w {tuple(wq.shape)}, scale "
                         f"{tuple(scale.shape)}, stride {stride}, lhs_dilation {lhs_dilation}")
    return conv_s8_launch(x, wq, scale, geometry, out_dtype, x_inv_scale,
                          conv_s8_variant(I, stride, lhs_dilation))


def conv_s8_launch(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, geometry: dict,
                   out_dtype: torch.dtype, x_inv_scale, variant: str) -> torch.Tensor:
    """Launch route `variant` on operands checked by the caller (`conv_s8`);
    counts the launch. "mma_sync" takes any geometry (a float x quantized by
    `quantize` first), "wgmma" those `conv_s8_variant` gives it."""
    B, H, W, I = x.shape
    O, _, kh, kw = wq.shape
    stride, pad0, lhs_dilation = (geometry[k] for k in ("stride", "pad0", "lhs_dilation"))
    Ho = out_size(H, kh, stride, pad0, geometry["pad1"], lhs_dilation)
    Wo = out_size(W, kw, stride, pad0, geometry["pad1"], lhs_dilation)
    if Ho < 1 or Wo < 1:
        raise ValueError(f"conv_s8: empty output {Ho}x{Wo}")
    x, scale = x.contiguous(), scale.contiguous()
    out = torch.empty((B, Ho, Wo, O), dtype=out_dtype, device=x.device)
    lib = cuda.library()
    if variant == "wgmma":
        if conv_s8_variant(I, stride, lhs_dilation) != "wgmma":
            raise ValueError(f"conv_s8: the wgmma route does not take I {I}, stride {stride}, "
                             f"lhs_dilation {lhs_dilation}")
        if x.data_ptr() % 16:
            x = x.clone()  # a view off a 16-byte line: the gather's loads need one
        phase_list = phases(kh, kw, stride, pad0, lhs_dilation, Ho, Wo)
        packed = pack_weights(wq, phase_list, lhs_dilation)
        table = (ctypes.c_int * (8 * len(phase_list)))(*(v for ph in phase_list for v in ph[2:]))
        with cuda.launch_device(x):
            status = lib.cg_conv_s8_wgmma(
                x.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(), B, H, W,
                I, Ho, Wo, O, packed.shape[2], stride, lhs_dilation, len(phase_list), table,
                X_CODES[x.dtype], float(x_inv_scale or 0.0), OUT_CODES[out_dtype],
                cuda.stream_handle(x))
    else:
        xq = x if x_inv_scale is None else quantize(x, x_inv_scale)
        packed = pack_weights(wq)
        vec16 = int(I % 16 == 0 and xq.data_ptr() % 16 == 0)
        with cuda.launch_device(x):
            status = lib.cg_conv_s8(
                xq.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(), B, H, W,
                I, Ho, Wo, O, kh, kw, packed.shape[2], stride, pad0, lhs_dilation,
                OUT_CODES[out_dtype], vec16, cuda.stream_handle(x))
    cuda.check(status, "conv_s8")
    conv_s8.launches += 1
    conv_s8.launches_by_variant[variant] += 1
    return out


conv_s8.launches = 0
conv_s8.launches_by_variant = {"wgmma": 0, "mma_sync": 0}


def quantize(x: torch.Tensor, x_inv_scale: float) -> torch.Tensor:
    """x -> int8: round(float32(x) * x_inv_scale), half to even, clipped to
    +-127 (PyTorch passes over an fp32 copy; the wgmma route does this in
    its gather)."""
    y = x.to(torch.float32, copy=True)   # one fp32 buffer, updated in place
    y.mul_(x_inv_scale).round_().clamp_(-127, 127)
    return y.to(torch.int8)
