"""StyleGAN2 modulated/demodulated convolution on NHWC tensors.

Behavioral reference: stylegan2/modules.py:920-967 (ConvLayer.forward_mod)
and 1089-1139 (fused ConvUpLayer). As in the JAX package, the per-sample
kernels are re-associated into ordinary batched convs:

    conv(x, w * s[b]) == conv(x * s[b], w)     (linearity in channels)
    demod d[b,o] depends only on (w, s[b]) and commutes with the depthwise
    FIR, so it scales the conv OUTPUT.

Activations are NHWC at every function boundary; inside, the NCHW view of an
NHWC tensor is channels_last memory, which is what cuDNN's convs take.
Conv weights are OIHW (the JAX package's HWIO, transposed at import), with
the equalized-lr scale already folded in.

`modulated_matmul` is the wrapper of the hand-written CUDA kernel
(csrc/modulated_matmul.cu) that computes the ToRGB 1x1 modulated conv: a
CUDA tensor launches the kernel, a CPU tensor takes `modulated_matmul_plain`.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from clip_glass_torch.core.device import constant
from clip_glass_torch.ops import cuda, quant
from clip_glass_torch.ops.conv_s8 import conv_s8
from clip_glass_torch.ops.upfirdn import fir, pad_hw


def _conv(x: torch.Tensor, w: torch.Tensor, *, stride=1, pad0=0, pad1=0,
          lhs_dilation=1) -> torch.Tensor:
    """x: [B, H, W, I]; w: [O, I, kh, kw]; correlation with explicit padding
    (pad0 before, pad1 after, on both spatial axes; negative crops) of the
    input dilated by `lhs_dilation` (lhs_dilation-1 zeros between samples),
    as the JAX package's lax.conv_general_dilated call. The call site of the
    int8 mode (ops/quant.py): inside a calibration or int8 scope an eligible
    conv records its input's absmax or runs as `conv_s8`, as the JAX
    package's `_conv` hands its operands to quant.conv_hook."""
    geometry = dict(stride=stride, pad0=pad0, pad1=pad1, lhs_dilation=lhs_dilation)

    def run(xx, ww, scale, x_inv_scale):
        if scale is None:
            return _conv_float(xx, ww, **geometry)
        return conv_s8(xx, ww, scale, out_dtype=x.dtype, x_inv_scale=x_inv_scale,
                       **geometry)

    return quant.conv_hook(x, w, run)


def _conv_float(x: torch.Tensor, w: torch.Tensor, *, stride=1, pad0=0, pad1=0,
                lhs_dilation=1) -> torch.Tensor:
    """`_conv`'s float conv, never quantized: cuDNN on NHWC activations (the
    NCHW view of channels_last memory). BigGAN's plain convs call it
    directly, as the JAX package calls lax.conv_general_dilated there."""
    xn = x.permute(0, 3, 1, 2)
    if lhs_dilation > 1:
        y = _conv_dilated(xn, w, lhs_dilation, pad0, pad1)
    elif pad0 == pad1:
        y = F.conv2d(xn, w, stride=stride, padding=pad0)
    else:
        y = F.conv2d(pad_hw(xn, pad0, pad1), w, stride=stride)
    return y.permute(0, 2, 3, 1)


def _conv_dilated(xn: torch.Tensor, w: torch.Tensor, d: int, pad0: int,
                  pad1: int) -> torch.Tensor:
    """NCHW correlation of the d-dilated input padded by (pad0, pad1), as a
    transposed conv with the flipped, in/out-swapped kernel (no zero-stuffed
    copy, no products with the stuffed zeros). conv_transpose2d(stride=d)
    equals the dilated input padded by k-1 on both sides; the output is
    then cropped (a view, no copy) or zero-padded by pad - (k-1) at each
    end."""
    k = w.shape[-1]
    y = F.conv_transpose2d(xn, w.transpose(0, 1).flip(2, 3), stride=d)
    a, b = pad0 - (k - 1), pad1 - (k - 1)
    if a <= 0 and b <= 0:
        return y[:, :, -a:y.shape[2] + b, -a:y.shape[3] + b]
    return pad_hw(y, a, b)


def style_from_latent(latent, style_w, style_b):
    """Per-sample channel scales: dense(latent) with bias_init=1 semantics
    (reference stylegan2/modules.py:874-890; the +1 lives in the bias)."""
    return latent @ style_w + style_b


def demod_coef(w: torch.Tensor, style: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """d[b,o] = rsqrt(sum_{i,k}(w[o,i,k] * s[b,i])^2 + eps), in fp32."""
    w32 = w.float()
    w2 = (w32 * w32).sum(dim=(2, 3))                 # [O, I]
    s2 = style.float().square()                      # [B, I]
    return torch.rsqrt(s2 @ w2.t() + eps)            # [B, O]


def modulated_conv2d(x, w, style, *, demodulate: bool = True, eps: float = 1e-8):
    """Plain modulated conv. x: [B,H,W,I]; w: [O,I,k,k]; style: [B,I].
    'SAME' padding of the reference ConvLayer (modules.py:896-903)."""
    k = w.shape[-1]
    pad = k - 1
    pad0 = pad - pad // 2
    xs = x * style[:, None, None, :].to(x.dtype)
    y = _conv(xs, w, pad0=pad0, pad1=pad - pad0)
    if demodulate:
        y = y * demod_coef(w, style, eps).to(y.dtype)[:, None, None, :]
    return y


def modulated_conv2d_up(x, w, style, *, demodulate: bool = True,
                        filter_taps=(1, 3, 3, 1), eps: float = 1e-8):
    """Fused 2x-upsampling modulated conv (reference modules.py:1043-1072,
    1093-1139, pad_once layout): transposed conv, stride 2, no padding, then
    the FIR with pad = (fk-2)-(k-1), pad0 = (pad+1)//2+1, pad1 = pad//2+1."""
    k = w.shape[-1]
    xs = x * style[:, None, None, :].to(x.dtype)
    if quant.hooked(w.shape):
        # inside a calibration or int8 scope, the JAX package's form, a call
        # site of the int8 mode: the flipped kernel's correlation with the
        # 2-dilated input
        y = _conv(xs, w.flip(2, 3), lhs_dilation=2, pad0=k - 1, pad1=k - 1)
    else:
        y = F.conv_transpose2d(xs.permute(0, 3, 1, 2), w.transpose(0, 1), stride=2)
        y = y.permute(0, 2, 3, 1)
    pad = (len(filter_taps) - 2) - (k - 1)
    # the FIR's gain is up_factor ** 2
    y = fir(y.contiguous(), filter_taps, 4.0, (pad + 1) // 2 + 1, pad // 2 + 1)
    if demodulate:
        y = y * demod_coef(w, style, eps).to(y.dtype)[:, None, None, :]
    return y


@lru_cache(maxsize=None)
def _up_phase_map(filter_taps):
    """Constant coefficient tensor A[d, r, t] = sum_{s: s+t=2d+1-r (valid)}
    k1[s] of the convT+FIR polyphase composition (one per dimension)."""
    k1 = np.asarray(filter_taps, np.float64)
    k1 = k1 / k1.sum() * 2.0  # separable 1-D factor (total FIR gain 4)
    A = np.zeros((3, 2, 3), np.float32)
    for r in (0, 1):
        for t in range(3):
            for s in range(len(k1)):
                d2 = s + t - 3 + r
                if d2 % 2 == 0 and -2 <= d2 <= 2:
                    A[d2 // 2 + 1, r, t] += k1[s]
    return A


def _polyphase_up_kernels(w: torch.Tensor, filter_taps) -> torch.Tensor:
    """Compose convT(stride 2, k=3) + 4-tap FIR into FOUR 3x3 phase kernels:
    out[2p+r, 2q+c] = conv(x, K[r,c])[p, q] with
      K[r,c][di,dj] = sum_{s1+t1=2di+3-r, s2+t2=2dj+3-c} k1[s1] k1[s2] w[2-t1, 2-t2]
    (the zero-stuffing and padding arithmetic of modulated_conv2d_up).
    w: [O, I, 3, 3]. Returns the JAX package's layout, [3, 3, I, 4, O]
    (phases r-major), in fp32 composed and rounded once to w's dtype."""
    A = constant(_up_phase_map, tuple(filter_taps), device=w.device)
    wf = w.permute(2, 3, 1, 0).float().flip(0, 1)   # HWIO w[2-t1, 2-t2]
    Kp = torch.einsum("drt,ecs,tsio->deirco", A, A, wf)
    d, e, I, r, c, O = Kp.shape
    return Kp.reshape(d, e, I, r * c, O).to(w.dtype)


def conv2d(x, w, *, stride=1):
    """Unmodulated 'SAME' conv (reference ConvLayer without modulation)."""
    k = w.shape[-1]
    pad = k - 1
    pad0 = pad - pad // 2
    return _conv(x, w, stride=stride, pad0=pad0, pad1=pad - pad0)


def conv2d_down(x, w, *, filter_taps=(1, 3, 3, 1)):
    """FIR + stride-2 conv (reference ConvDownLayer, pad_once=True,
    modules.py:1197-1232): FIR pad = (fk-2)+(k-1), split ((pad+1)//2,
    pad//2), then a stride-2 VALID conv."""
    k = w.shape[-1]
    pad = (len(filter_taps) - 2) + (k - 1)
    # the FIR kernel takes contiguous NHWC: a copy only where D's input is
    # a view (the plain domain's first block reads the NCHW image)
    y = fir(x.contiguous(), filter_taps, 1.0, (pad + 1) // 2, pad // 2)
    return _conv(y, w, stride=2)


def modulated_matmul_plain(x: torch.Tensor, style: Optional[torch.Tensor],
                           w: torch.Tensor, demod: Optional[torch.Tensor],
                           bias: torch.Tensor) -> torch.Tensor:
    """y[b,p,o] = (sum_i x[b,p,i] * s[b,i] * w[i,o]) * d[b,o] + bias[o] in
    fp32, rounded once to x's dtype. style/demod None = ones."""
    xs = x.float()
    if style is not None:
        xs = xs * style.float()[:, None, :]
    y = xs @ w.float()
    if demod is not None:
        y = y * demod.float()[:, None, :]
    return (y + bias.float()).to(x.dtype)


# the C entry point of each kernel variant (csrc/modulated_matmul.cu)
MODULATED_MATMUL_ENTRY = {"mma": "cg_modulated_matmul_mma",
                          "chunked": "cg_modulated_matmul"}
_entries: dict = {}  # variant -> bound C function, filled at first CUDA use
_LAUNCH_SIZED = 2 * 1024 * 1024  # input values up to which the launch is the cost


@lru_cache(maxsize=None)
def modulated_matmul_variant(dtype: torch.dtype, B: int, P: int, I: int, O: int,
                             vec: int) -> str:
    """The kernel that modulated_matmul launches, from x's dtype and shape,
    O, and the access width `vec` that x's row length and alignment allow
    (`cuda.vector_width`): "mma" (the loaded 16-byte vectors are the
    tensor cores' A fragments, the folded weights, split exactly into two
    bf16 values each, their B fragments) for bf16 with O = 3 and I of 32,
    64, 128, 256 or 512 on more than 2 Mi input values, the ToRGB calls of
    the flagship from 32 px up; "chunked" (weights in shared memory, outputs
    4 at a time) for everything else: fp32, other O and I, scalar rows, and
    launch-sized bf16 inputs that "mma" would take, the flagship's calls at
    4, 8 and 16 px (its one round of loads beats the eight of a 512-wide row
    there)."""
    if (dtype == torch.bfloat16 and O == 3 and vec == 8
            and I in (32, 64, 128, 256, 512) and B * P * I > _LAUNCH_SIZED):
        return "mma"
    return "chunked"


def modulated_matmul(x: torch.Tensor, style: Optional[torch.Tensor],
                     w: torch.Tensor, demod: Optional[torch.Tensor],
                     bias: torch.Tensor) -> torch.Tensor:
    """x: [B, P, I]; style: [B, I] or None; w: [I, O]; demod: [B, O] or None;
    bias: [O]. Returns [B, P, O]. CUDA: the hand-written kernel (every
    operand in x's dtype), the variant `modulated_matmul_variant` picks,
    differentiable as its plain version (`cuda.with_grad`); CPU:
    `modulated_matmul_plain`; meta: the kernel's output (`cuda.dispatch`)."""
    return cuda.dispatch(x, _modulated_matmul_cuda, _modulated_matmul_meta,
                         modulated_matmul_plain, x, style, w, demod, bias)


def _modulated_matmul_meta(x, style, w, demod, bias) -> torch.Tensor:
    """The kernel's shape rule: [B, P, O] in x's dtype."""
    return x.new_empty((x.shape[0], x.shape[1], w.shape[1]))


def _modulated_matmul_cuda(x, style, w, demod, bias) -> torch.Tensor:
    cuda.require_cuda("modulated_matmul", x, style, w, demod, bias, dtype=x.dtype)
    B, P, I = x.shape
    O = w.shape[1]
    if (w.shape != (I, O) or bias.shape != (O,)
            or (style is not None and style.shape != (B, I))
            or (demod is not None and demod.shape != (B, O))):
        given = [t for t in (x, style, w, demod, bias) if t is not None]
        raise ValueError("modulated_matmul: inconsistent shapes "
                         f"{[tuple(t.shape) for t in given]}")
    vec = cuda.vector_width(x.dtype, I, x)
    return modulated_matmul_launch(
        x, style, w, demod, bias,
        modulated_matmul_variant(x.dtype, B, P, I, O, vec))


def modulated_matmul_launch(x, style, w, demod, bias, variant: str) -> torch.Tensor:
    """Launch kernel variant `variant` on operands checked by the caller;
    counts the launch. "mma" takes bf16 with O = 3 only."""
    B, P, I = x.shape
    O = w.shape[1]
    if variant == "mma" and (O != 3 or x.dtype != torch.bfloat16):
        raise ValueError(f"modulated_matmul: variant {variant} does not take "
                         f"O={O}, {x.dtype}")
    out = x.new_empty((B, P, O))
    fn = _entries.get(variant)
    if fn is None:
        fn = _entries[variant] = getattr(cuda.library(),
                                         MODULATED_MATMUL_ENTRY[variant])
    ptrs = (x.data_ptr(), style.data_ptr() if style is not None else None,
            w.data_ptr(), demod.data_ptr() if demod is not None else None,
            bias.data_ptr(), out.data_ptr())
    if variant != "mma" and 4 * 4 * I > 48 * 1024:
        raise ValueError(f"modulated_matmul: I={I} exceeds the kernel's "
                         "shared-memory weight tile")
    with cuda.launch_device(x):
        if variant == "mma":
            status = fn(*ptrs, B, P, I, cuda.stream_handle(x))
        else:
            status = fn(*ptrs, B, P, I, O, cuda.DTYPE_CODES[x.dtype],
                        cuda.vector_width(x.dtype, I, x), cuda.stream_handle(x))
    if status:
        cuda.check(status, "modulated_matmul")
    modulated_matmul.launches += 1
    modulated_matmul.launches_by_variant[variant] += 1
    return out


modulated_matmul.launches = 0
modulated_matmul.launches_by_variant = {"mma": 0, "chunked": 0}
