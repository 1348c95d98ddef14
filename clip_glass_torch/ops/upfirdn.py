"""FIR up/down-sampling (upfirdn2d family) on NHWC tensors.

Behavioral reference: stylegan2/modules.py:459-676 (FilterLayer, Upsample,
Downsample): depthwise FIR convs around zero-stuffing / striding. Same
arithmetic as the JAX package's ops/upfirdn.py: a correlation with the
separable kernel of `setup_filter_kernel`, explicit asymmetric padding.

`upsample2x` and `fir` are the wrappers of hand-written CUDA kernels
(csrc/upsample2x.cu, csrc/fir.cu): a CUDA tensor launches the kernel, a CPU
tensor takes the plain version (`upsample2x_plain`, `fir_plain`).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from clip_glass_torch.core.profiling import TRACER
from clip_glass_torch.ops import cuda


@lru_cache(maxsize=None)
def setup_filter_kernel(filter_taps: tuple = (1, 3, 3, 1), gain: float = 1.0,
                        up_factor: int = 1) -> np.ndarray:
    """1-D taps -> normalized separable 2-D kernel * gain * up_factor^2
    (reference stylegan2/modules.py:169-203)."""
    k1 = np.asarray(filter_taps, np.float32)
    k2 = np.outer(k1, k1)
    k2 /= k2.sum()
    return (k2 * gain * up_factor ** 2).astype(np.float32)


def zero_stuff(x: torch.Tensor, factor: int) -> torch.Tensor:
    """NCHW: insert factor-1 zeros between samples (lhs dilation): H -> (H-1)*f+1."""
    if factor == 1:
        return x
    B, C, H, W = x.shape
    z = x.new_zeros(B, C, (H - 1) * factor + 1, (W - 1) * factor + 1)
    z[:, :, ::factor, ::factor] = x
    return z


def pad_hw(x: torch.Tensor, pad0: int, pad1: int) -> torch.Tensor:
    """NCHW: pad (or, for negative values, crop) both spatial axes."""
    return F.pad(x, (pad0, pad1, pad0, pad1))


def _depthwise(x: torch.Tensor, kernel2d, *, stride=1, lhs_dilation=1,
               pad0=0, pad1=0) -> torch.Tensor:
    """x: [B, H, W, C]; kernel2d: [kh, kw] correlated with every channel."""
    C = x.shape[-1]
    k = torch.as_tensor(kernel2d, dtype=x.dtype, device=x.device)
    w = k[None, None].expand(C, 1, *k.shape)
    xn = pad_hw(zero_stuff(x.permute(0, 3, 1, 2), lhs_dilation), pad0, pad1)
    y = F.conv2d(xn, w, stride=stride, groups=C)
    return y.permute(0, 2, 3, 1)


def upsample2x_plain(x: torch.Tensor, filter_taps=(1, 3, 3, 1),
                     gain: float = 1.0) -> torch.Tensor:
    """2x FIR upsample (reference stylegan2/modules.py:549-604): zero-stuff
    then filter with pad ((k-1+1)//2+1, (k-1)//2); kernel gain x4."""
    k2 = setup_filter_kernel(tuple(filter_taps), gain, up_factor=2)
    pad = k2.shape[-1] - 1
    return _depthwise(x, k2, lhs_dilation=2,
                      pad0=(pad + 1) // 2 + 1, pad1=pad // 2)


@lru_cache(maxsize=None)
def _fir_taps(filter_taps: tuple, gain: float) -> tuple:
    k1d = np.asarray(filter_taps, np.float64)
    k1d = k1d / k1d.sum() * (gain ** 0.5)
    return tuple(float(v) for v in k1d)


def fir_taps(filter_taps=(1, 3, 3, 1), gain: float = 1.0) -> tuple:
    """Per-axis factors of the separable kernel: normalized taps *
    sqrt(gain), so that outer(k, k) == setup_filter_kernel(taps, gain).
    Computed once per (taps, gain); exact in bf16 for (1, 3, 3, 1) at gains
    1 and 4."""
    return _fir_taps(tuple(filter_taps), float(gain))


# the C entry point of each kernel variant (csrc/upsample2x.cu)
UPSAMPLE2X_ENTRY = {"tiled": "cg_upsample2x_tiled", "rows": "cg_upsample2x"}
_TILED_STAGE_BYTES = 32 * 1024
_LAUNCH_SIZED = 16 * 1024  # input values up to which the launch is the cost
_entries: dict = {}  # variant -> bound C function, filled at first CUDA use


def upsample2x_variant(dtype: torch.dtype, B: int, H: int, W: int, C: int) -> str:
    """The kernel that upsample2x launches, from x's dtype and shape alone:
    "tiled" (whole input rows staged in shared memory, 16-byte loads and
    stores, a persistent grid) where five input rows fit one 32 KB stage,
    the RGB-skip calls of the flagship from 32 px up; "rows" (one thread per
    output value, one round trip to memory instead of two) for longer rows
    and for launch-sized inputs of at most 16384 values, the flagship's
    calls at 4, 8 and 16 px."""
    if B * H * W * C <= _LAUNCH_SIZED:
        return "rows"
    return "tiled" if 5 * W * C * dtype.itemsize <= _TILED_STAGE_BYTES else "rows"


def upsample2x(x: torch.Tensor, filter_taps=(1, 3, 3, 1),
               gain: float = 1.0) -> torch.Tensor:
    """[B, H, W, C] -> [B, 2H, 2W, C]. CUDA: the hand-written kernel
    (4 taps only), the variant `upsample2x_variant` picks, differentiable as
    its plain version (`cuda.with_grad`); CPU: `upsample2x_plain`; meta: the
    kernel's output (`cuda.dispatch`)."""
    return cuda.dispatch(x, _upsample2x_cuda, _upsample2x_meta, upsample2x_plain, x,
                         filter_taps, gain)


def _upsample2x_meta(x: torch.Tensor, filter_taps, gain: float) -> torch.Tensor:
    """The kernel's shape rule: [B, 2H, 2W, C] in x's dtype."""
    B, H, W, C = x.shape
    return x.new_empty((B, 2 * H, 2 * W, C))


def _upsample2x_cuda(x: torch.Tensor, filter_taps, gain: float) -> torch.Tensor:
    if len(filter_taps) != 4:
        raise ValueError("the CUDA upsample2x kernel takes 4 filter taps, "
                         f"got {len(filter_taps)}")
    cuda.require_cuda("upsample2x", x, dtype=x.dtype)
    # the upsample's polyphase factors: outer(k, k) ==
    # setup_filter_kernel(taps, gain, 2), whose gain is up_factor ** 2
    return upsample2x_launch(x, fir_taps(filter_taps, 4.0 * gain),
                             upsample2x_variant(x.dtype, *x.shape))


def upsample2x_launch(x: torch.Tensor, taps: tuple, variant: str) -> torch.Tensor:
    """Launch kernel variant `variant` on x (checked by the caller) with the
    per-axis factors `taps` from `fir_taps` (at gain x4); counts the launch."""
    B, H, W, C = x.shape
    out = x.new_empty((B, 2 * H, 2 * W, C))
    fn = _entries.get(variant)
    if fn is None:
        fn = _entries[variant] = getattr(cuda.library(), UPSAMPLE2X_ENTRY[variant])
    with cuda.launch_device(x):
        status = fn(x.data_ptr(), out.data_ptr(), B, H, W, C, *taps,
                    cuda.DTYPE_CODES[x.dtype], cuda.stream_handle(x))
    if status:
        cuda.check(status, "upsample2x")
    upsample2x.launches += 1
    upsample2x.launches_by_variant[variant] += 1
    return out


upsample2x.launches = 0
upsample2x.launches_by_variant = {"tiled": 0, "rows": 0}


def downsample2x(x: torch.Tensor, filter_taps=(1, 3, 3, 1),
                 gain: float = 1.0) -> torch.Tensor:
    """2x FIR downsample (reference stylegan2/modules.py:608-676)."""
    k2 = setup_filter_kernel(tuple(filter_taps), gain, up_factor=1)
    pad = k2.shape[-1] - 2
    return _depthwise(x, k2, stride=2, pad0=pad // 2, pad1=pad - pad // 2)


def fir_plain(x: torch.Tensor, filter_taps, gain: float, pad0: int, pad1: int,
              stride: int = 1) -> torch.Tensor:
    """FilterLayer (reference stylegan2/modules.py:459-527): x [B, H, W, C]
    correlated with setup_filter_kernel(filter_taps, gain) in every channel,
    padded by (pad0, pad1) on both spatial axes (negative crops), at
    `stride`."""
    k2 = setup_filter_kernel(tuple(filter_taps), float(gain))
    return _depthwise(x, k2, stride=stride, pad0=pad0, pad1=pad1)


def fir(x: torch.Tensor, filter_taps, gain: float, pad0: int, pad1: int,
        stride: int = 1) -> torch.Tensor:
    """`fir_plain`'s function. CUDA: the hand-written kernel (csrc/fir.cu:
    4 taps, stride 1, pads >= 0, contiguous x, 16-byte aligned where the
    variant `fir_variant` picks reads vectors; raises otherwise),
    differentiable as its plain version (`cuda.with_grad`); CPU:
    `fir_plain`; meta: the kernel's output (`cuda.dispatch`)."""
    return cuda.dispatch(x, _fir_cuda, _fir_meta, fir_plain, x, filter_taps, gain,
                         pad0, pad1, stride)


def _fir_shape(x: torch.Tensor, filter_taps, pad0: int, pad1: int, stride: int) -> tuple:
    """The kernel's output shape, [B, H+pad0+pad1-3, W+pad0+pad1-3, C];
    raises on what the kernel does not take."""
    if len(filter_taps) != 4 or stride != 1 or pad0 < 0 or pad1 < 0:
        raise ValueError("the CUDA fir kernel takes 4 filter taps, stride 1 and pads "
                         f">= 0, got {len(filter_taps)} taps, stride {stride}, pads "
                         f"({pad0}, {pad1})")
    B, H, W, C = x.shape
    shape = (B, H + pad0 + pad1 - 3, W + pad0 + pad1 - 3, C)
    if min(shape[1:3]) < 1:
        raise ValueError(f"fir: no output pixel for {tuple(x.shape)} padded ({pad0}, {pad1})")
    return shape


def _fir_meta(x, filter_taps, gain, pad0, pad1, stride) -> torch.Tensor:
    """The kernel's shape rule, in x's dtype."""
    return x.new_empty(_fir_shape(x, filter_taps, pad0, pad1, stride))


def _fir_cuda(x, filter_taps, gain, pad0, pad1, stride) -> torch.Tensor:
    _fir_shape(x, filter_taps, pad0, pad1, stride)
    cuda.require_cuda("fir", x, dtype=x.dtype)
    return fir_launch(x, fir_taps(filter_taps, gain), pad0, pad1,
                      fir_variant(x.dtype, x.shape[-1]))


def fir_variant(dtype: torch.dtype, C: int) -> str:
    """The kernel's variant, from x's dtype and channels: "vector" (16-byte
    vectors of channels, the input rows copied through a ring in shared
    memory) where C is a multiple of 16 bytes' values, every flagship call;
    "scalar" (a value a thread, read from global memory) otherwise."""
    return "vector" if C % (16 // dtype.itemsize) == 0 else "scalar"


def fir_launch(x: torch.Tensor, taps: tuple, pad0: int, pad1: int,
               variant: str) -> torch.Tensor:
    """Launch the kernel's variant `variant` on x (checked by the caller)
    with the per-axis factors `taps` from `fir_taps`; counts the launch in
    `fir.launches` and the tracer's `kernels.fir`."""
    global _fir_entry
    B, H, W, C = x.shape
    out = x.new_empty((B, H + pad0 + pad1 - 3, W + pad0 + pad1 - 3, C))
    vec = 16 // x.element_size() if variant == "vector" else 1
    if C % vec or (vec > 1 and x.data_ptr() % 16):
        raise ValueError(f"fir: variant {variant} does not take C={C} at this alignment")
    if _fir_entry is None:
        _fir_entry = cuda.library().cg_fir
    with cuda.launch_device(x):
        status = _fir_entry(x.data_ptr(), out.data_ptr(), B, H, W, C, pad0, pad1, *taps,
                            cuda.DTYPE_CODES[x.dtype], vec, cuda.stream_handle(x))
    if status:
        cuda.check(status, "fir")
    fir.launches += 1
    fir.launches_by_variant[variant] += 1
    TRACER.count("kernels.fir")
    return out


_fir_entry = None  # the bound C function, at first CUDA use
fir.launches = 0
fir.launches_by_variant = {"vector": 0, "scalar": 0}
