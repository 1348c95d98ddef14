"""Space-to-depth (s2d) execution domain of the StyleGAN2 and BigGAN-deep
fitness paths.

The JAX package's ops/s2d.py. StyleGAN2: the top levels of config-f (32-64
channels at 512-1024 px) run on tensors laid out as [B, H/2, W/2, 4C]
(phase-major: s2d(x)[b, p, q, (2r+c)*C + i] = x[b, 2p+r, 2q+c, i]). Every op
of those levels (modulated 3x3 conv, fused 2x-up conv, ToRGB, the RGB skip
upsample, D's FIR + stride-2 convs, the 224 px resize) is re-expressed
exactly as an ordinary conv on the packed tensor with a phase-composed
kernel, so no full-resolution tensor is made and no standalone depthwise FIR
runs at those levels. BigGAN-deep: the mid segment of the bottleneck blocks
at 256-512 px (the "BigGAN ops" below).

Lattice offsets: an s2d tensor at offset -1 stores cell v' as full-res rows
(2v'-1, 2v'), with one extra cell row/col whose phantom rows -1 and H are
zero. A same-res 3x3 conv between opposite lattices folds to a [2,2] kernel
on 4C channels; those convs go through the hand-written kernel
`s2d_conv2x2` (csrc/s2d_conv2x2.cu). Phantom entries must be zero wherever a
conv consumes them (`mask_phantoms_`).

Dispatch rule: every square [2,2] fold on the input's channels goes to
`s2d_conv2x2`, in both families (StyleGAN2's modulated convs and D's, and
BigGAN's unmodulated mid-segment convs with one shared weight set). The JAX
package sends these folds to its Pallas kernel only under
CLIP_GLASS_PALLAS_S2D=1 and to XLA's conv otherwise; the port has no such
switch, since both compute the same function. The exception is the int8
mode: inside its scopes an eligible fold takes the JAX package's default
form (`_conv`), the one that mode quantizes. The other folds stay cuDNN
convs.

The RGB path at those levels is carried in the 4x4 space-to-depth domain
(s4d, [B, H/4, W/4, 16C], offset-free).

Layouts: activations NHWC, as everywhere in the port. The folds keep the
JAX package's arithmetic and its HWIO kernel layout: each fold takes the
port's weight (OIHW convs, [I, O] ToRGB matrices), permutes it once on entry
and returns an HWIO kernel; `_conv_hwio` hands F.conv2d OIHW at the exit.
Rounding follows the JAX package: folds compose in fp32 and round once to the
activation dtype; G's weights arrive in the compute dtype, D's raw in fp32.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from clip_glass_torch.core.device import constant
from clip_glass_torch.ops import cuda, quant
from clip_glass_torch.ops.modulated_conv import _conv, _polyphase_up_kernels, demod_coef
from clip_glass_torch.ops.resize import bilinear_matrix
from clip_glass_torch.ops.upfirdn import setup_filter_kernel


def _hwio(w: torch.Tensor) -> torch.Tensor:
    """OIHW conv weight -> HWIO in fp32 (the folds' entry)."""
    return w.permute(2, 3, 1, 0).float()


def _conv_hwio(x, K, **kw):
    """_conv with an HWIO kernel, rounded to x's dtype (the folds' exit)."""
    return _conv(x, K.permute(3, 2, 0, 1).to(x.dtype), **kw)


# ------------------------------------------------------------ layout
#
# Offset convention: an s2d tensor with lattice offset `off` stores cell v'
# as full-res rows (2v' + off, 2v' + 1 + off). off=0 is the aligned lattice
# (H/2 cells); off=-1 has H/2 + 1 cells covering rows -1..H, where row -1
# (cell 0, phase 0) and row H (last cell, phase 1) are zero phantoms.


def n_cells(size: int, off: int = 0) -> int:
    """Cell count of one spatial dim of an s2d tensor at lattice `off`."""
    return size // 2 + (1 if off else 0)


def phys_size(n: int, off: int = 0) -> int:
    """Inverse of n_cells: full-res extent from the cell count."""
    return 2 * (n - (1 if off else 0))


def s2d(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/2, W/2, 4C], phase-major."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // 2, 2, W // 2, 2, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H // 2, W // 2, 4 * C)


def un_s2d(x: torch.Tensor) -> torch.Tensor:
    """[B, H/2, W/2, 4C] -> [B, H, W, C] (inverse of s2d)."""
    B, Hh, Wh, C4 = x.shape
    C = C4 // 4
    x = x.reshape(B, Hh, Wh, 2, 2, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, 2 * Hh, 2 * Wh, C)


def s2d_hw(n: torch.Tensor, off: int = 0) -> torch.Tensor:
    """Per-layer noise plane [H, W] -> [nh, nw, 4] (phase-major) on the
    lattice at `off` (phantom entries zero)."""
    if off:
        n = F.pad(n, (1, 1, 1, 1))
    H, W = n.shape
    return n.reshape(H // 2, 2, W // 2, 2).permute(0, 2, 1, 3).reshape(
        H // 2, W // 2, 4).contiguous()


def un_s2d_off(x: torch.Tensor, off: int = 0) -> torch.Tensor:
    """s2d tensor at lattice `off` -> plain [B, H, W, C] (phantoms dropped)."""
    y = un_s2d(x)
    if off:
        y = y[:, 1:-1, 1:-1, :]
    return y


def shift_to_m1(x: torch.Tensor) -> torch.Tensor:
    """Re-lattice an offset-0 s2d tensor to offset -1: [B,n,n,4C] ->
    [B,n+1,n+1,4C] with zero phantoms."""
    C = x.shape[-1] // 4
    p00, p01, p10, p11 = (x[..., i * C:(i + 1) * C] for i in range(4))

    def pad(a, t, l):
        return F.pad(a, (0, 0, l, 1 - l, t, 1 - t))

    # new phase (rp, cp) of cell (v, w) = full-res row/col (2v+rp-1, 2w+cp-1)
    return torch.cat([
        pad(p11, 1, 1),   # (0,0): old (1,1)[v-1, w-1]
        pad(p10, 1, 0),   # (0,1): old (1,0)[v-1, w]
        pad(p01, 0, 1),   # (1,0): old (0,1)[v, w-1]
        pad(p00, 0, 0),   # (1,1): old (0,0)[v, w]
    ], dim=-1)


def mask_phantoms_(x: torch.Tensor) -> torch.Tensor:
    """Zero the phantom row/col entries of an offset -1 s2d tensor, IN PLACE
    (only the border cells are written; every caller hands a fresh tensor),
    and return it. The JAX package multiplies by two 0/1 masks instead."""
    C = x.shape[-1] // 4
    x[:, 0, :, :2 * C] = 0         # row -1 lives in phases rp=0
    x[:, -1, :, 2 * C:] = 0        # row H lives in phases rp=1
    for lo in (0, 2 * C):          # col -1 lives in phases cp=0
        x[:, :, 0, lo:lo + C] = 0
    for lo in (C, 3 * C):          # col W lives in phases cp=1
        x[:, :, -1, lo:lo + C] = 0
    return x


def tile_channels(v: torch.Tensor, phases: int = 4) -> torch.Tensor:
    """Per-channel vector [..., C] -> [..., phases*C] matching the
    phase-major layout (every phase carries the same per-channel value)."""
    return torch.cat([v] * phases, dim=-1)


# ------------------------------------------------------------ kernel folding
#
# Every transform below rewrites  y[v] = sum_t K[t] * x[s*v + t - p]  (per
# spatial dim) onto the half lattices v = 2v' + rv, j = 2j' + rj:
#     j' = s'*v' + floor((s*rv + t - p) / 2),   rj = (s*rv + t - p) mod 2
# so the op stays an ordinary conv with kernel indexed by (offset, rj, rv).


@lru_cache(maxsize=None)
def _fold_map(kh: int, p0: int, stride: int, fi: int, fo: int, sh: int):
    """Constant per-dimension 0/1 mapping tensor M[d, a, rj, rv] of the
    lattice fold (tap a of output phase rv lands at folded tap d, input
    phase rj). Returns (M, omin, kh')."""
    offs = [(stride * rv + a - p0 + sh) for rv in range(fo) for a in range(kh)]
    omin = min(o // fi for o in offs)
    kh_new = max(o // fi for o in offs) - omin + 1
    M = np.zeros((kh_new, kh, fi, fo), np.float32)
    for rv in range(fo):
        for a in range(kh):
            uh = stride * rv + a - p0 + sh
            M[uh // fi - omin, a, uh % fi, rv] = 1.0
    return M, omin, kh_new


def _fold_matrix(*args):
    return _fold_map(*args)[0]


def _fold(K: torch.Tensor, p0: int, stride: int, in_s2d: bool, out_s2d: bool,
          in_off: int = 0, out_off: int = 0):
    """Fold a stride-`stride` conv kernel K [kh, kw, I, O] (HWIO) with pad
    start `p0` onto s2d input/output lattices at offsets `in_off`/`out_off`.
    Returns (K' HWIO fp32, p0', kh'). Exact; one einsum against a constant
    mapping tensor."""
    kh, kw, I, O = K.shape
    fo = 2 if out_s2d else 1
    fi = 2 if in_s2d else 1
    s_new, rem = divmod(stride * fo, fi)
    assert rem == 0 and s_new >= 1, "lattice ratio must stay integral"
    # X index = stride * (fo*v' + rv + out_off) + t - p0 = fi*j' + rj + in_off
    sh = (stride * out_off if out_s2d else 0) - (in_off if in_s2d else 0)
    _, omin, kh_new = _fold_map(kh, p0, stride, fi, fo, sh)
    M = constant(_fold_matrix, kh, p0, stride, fi, fo, sh, device=K.device)
    # ci = (rjh*fi + rjw)*I + i  (J,K,i);  co = (rv*fo + rc)*O + o  (R,S,o)
    Kp = torch.einsum("DaJR,EbKS,abio->DEJKiRSo", M, M, K.float())
    Kp = Kp.reshape(kh_new, kh_new, fi * fi * I, fo * fo * O)
    return Kp, -omin, kh_new


@lru_cache(maxsize=None)
def _down_composite_taps(k: int, filter_taps: tuple):
    """Compose depthwise FIR + stride-2 conv (reference ConvDownLayer,
    stylegan2/modules.py:1197-1232) into one (k + fk - 1)-tap stride-2 conv's
    FIR coefficient table and pad start."""
    fk = setup_filter_kernel(filter_taps, gain=1.0, up_factor=1)
    pad = (fk.shape[-1] - 2) + (k - 1)
    return fk, (pad + 1) // 2


def s2d_same_kernel(w: torch.Tensor, in_off: int = 0, out_off: int = 0):
    """Stride-1 'SAME' conv (reference ConvLayer pads: pad0 = (k-1) -
    (k-1)//2) on an s2d tensor: w [O, I, k, k] -> (K' [kh', kw', 4I, 4O]
    HWIO fp32, pad'). With in_off != out_off a 3x3 kernel folds to [2,2]."""
    k = w.shape[-1]
    p0 = (k - 1) - (k - 1) // 2
    Kp, pad0, _ = _fold(_hwio(w), p0, 1, True, True, in_off, out_off)
    return Kp, pad0


def _pad1_for(n_in: int, n_out: int, k: int, stride: int, pad0: int) -> int:
    """Trailing pad that makes a VALID-counted conv emit exactly n_out
    (negative: the conv's input is cropped)."""
    return (n_out - 1) * stride + k - pad0 - n_in


def s2d_up_kernel(w: torch.Tensor, filter_taps=(1, 3, 3, 1)):
    """Fused 2x-up modulated conv (transposed conv + FIR) from a PLAIN input
    to an s2d output: the four composed phase kernels stacked phase-major.
    Returns ([3,3,I,4O] HWIO in w's dtype, pad0=1)."""
    Kp = _polyphase_up_kernels(w, tuple(filter_taps))  # [3,3,I,4,O]
    kh, kw, I, _, O = Kp.shape
    return Kp.reshape(kh, kw, I, 4 * O), 1


@lru_cache(maxsize=None)
def _dilated_fold_map():
    """0/1 tensor U[f, a, rj]: dilated-conv tap index f = a + 1 - rj."""
    U = np.zeros((4, 3, 2), np.float32)
    for a in range(3):
        for rj in range(2):
            U[a + 1 - rj, a, rj] = 1.0
    return U


def s2d_up_kernel_from_s2d(w: torch.Tensor, filter_taps=(1, 3, 3, 1),
                           in_off: int = 0):
    """Fused 2x-up modulated conv from an s2d INPUT (lattice `in_off`) to an
    s2d output at offset 0: the polyphase kernel's input side folded onto
    the half lattice, a lhs_dilation=2 conv at the physical level. Returns
    ([4,4,4I,4O] HWIO fp32, pad0 = 2 + in_off)."""
    Kp = _polyphase_up_kernels(w, tuple(filter_taps))  # [3,3,I,4,O]
    kh, kw, I, _, O = Kp.shape
    Kp32 = Kp.reshape(kh, kw, I, 4 * O).float()
    U = constant(_dilated_fold_map, device=w.device)
    Kd = torch.einsum("FaJ,GbK,abim->FGJKim", U, U, Kp32)
    return Kd.reshape(4, 4, 4 * I, 4 * O), 2 + in_off


@lru_cache(maxsize=None)
def _compose_map(kk: int, n_fir: int, k: int):
    """0/1 tensor G[u, s, t]: 2-D convolution index u = s + t (composing the
    depthwise FIR with the conv kernel as one einsum)."""
    G = np.zeros((kk, n_fir, k), np.float32)
    for s in range(n_fir):
        for t in range(k):
            G[s + t, s, t] = 1.0
    return G


def s2d_down_kernel(w: torch.Tensor, filter_taps=(1, 3, 3, 1),
                    out_s2d: bool = False, in_off: int = 0, out_off: int = 0):
    """FIR + stride-2 conv (reference ConvDownLayer) from an s2d input to a
    half-res output: PLAIN ([kh',kw',4I,O], stride 1 at the physical level)
    or s2d ([kh',kw',4I,4O], stride 2). w: [O, I, k, k], composed in fp32.
    Returns (K' HWIO fp32, pad0', stride')."""
    k = w.shape[-1]
    fk, p0 = _down_composite_taps(k, tuple(filter_taps))
    kk = k + fk.shape[-1] - 1
    G = constant(_compose_map, kk, fk.shape[-1], k, device=w.device)
    fkt = constant(setup_filter_kernel, tuple(filter_taps), 1.0, 1, device=w.device)
    C = torch.einsum("Usa,Vtb,st,abio->UVio", G, G, fkt, _hwio(w))
    Kp, pad0, _ = _fold(C, p0, 2, True, out_s2d, in_off, out_off)
    return Kp, pad0, (2 if out_s2d else 1)


@lru_cache(maxsize=None)
def _upsample2x_s2d_taps(filter_taps: tuple, gain: float):
    """FIR 2x upsample (reference Upsample, stylegan2/modules.py:549-604)
    from a PLAIN input to an s2d output: per-phase 2-tap polyphase of the
    separable kernel. Returns [2, 2, 2, 2] = [dj, dk, rv, rc] coefficients."""
    k2 = setup_filter_kernel(filter_taps, gain, up_factor=2)
    T = np.zeros((2, 2, 2, 2), np.float64)
    for rv in range(2):
        for dj in range(2):
            s1 = 2 * dj + 1 - rv            # tap of the 4-tap filter
            for rc in range(2):
                for dk in range(2):
                    s2 = 2 * dk + 1 - rc
                    T[dj, dk, rv, rc] = k2[s1, s2]
    return T


def _upsample2x_s2d_kernel(filter_taps: tuple, gain: float, C: int):
    T = _upsample2x_s2d_taps(filter_taps, gain)
    K = np.zeros((2, 2, C, 4 * C), np.float64)
    for rv in range(2):
        for rc in range(2):
            for i in range(C):
                K[:, :, i, (rv * 2 + rc) * C + i] = T[:, :, rv, rc]
    return K


def s2d_upsample2x(y: torch.Tensor, filter_taps=(1, 3, 3, 1),
                   gain: float = 1.0) -> torch.Tensor:
    """upsample2x(y) in s2d form: [B,H,W,C] -> [B,H,W,4C] (phys same res)."""
    K = constant(_upsample2x_s2d_kernel, tuple(filter_taps), float(gain),
                 y.shape[-1], device=y.device, dtype=y.dtype)
    return _conv_hwio(y, K, pad0=1, pad1=0)


# ------------------------------------------------------------ kernel 4


def s2d_conv2x2_plain(x: torch.Tensor, K: torch.Tensor, style, demod,
                      pad0: int) -> torch.Tensor:
    """y[b,v,w] = sum_{a,c in {0,1}} x[b, v+a-pad0, w+c-pad0] @ Kb[b,a,c] with
    Kb[b] = K * style[b][:, None] * demod[b][None, :] folded in fp32 and
    rounded to x's dtype; out-of-range cells read zero; the four shifted
    products are summed in fp32 and rounded once. pad0=1: n_out = n+1;
    pad0=0: n_out = n-1. x: [B,n,n,C']; K: [2,2,C',C'] (HWIO);
    style/demod: [B,C'], or None for ones."""
    B, n, _, C = x.shape
    n_out = n + 1 if pad0 else n - 1
    Kb = _fold_style(K, style, demod).to(x.dtype).float()
    if Kb.shape[0] != B:  # one shared set: the same layout as B folded copies
        Kb = Kb.expand(B, -1, -1, -1, -1).contiguous()
    xp = F.pad(x, (0, 0, pad0, n_out + 1 - n - pad0, pad0, n_out + 1 - n - pad0))
    y = None
    for a in range(2):
        for c in range(2):
            xs = xp[:, a:a + n_out, c:c + n_out, :].float().reshape(B, -1, C)
            t = torch.bmm(xs, Kb[:, a, c])
            y = t if y is None else y + t
    return y.reshape(B, n_out, n_out, C).to(x.dtype)


def _fold_style(K, style, demod):
    """Kb[b] = K * style[b][:, None] * demod[b][None, :] in fp32 (the
    per-sample weight modulation of the reference, modules.py:920-967):
    [B,2,2,C',C']. None stands for ones and skips its product; with neither,
    one set [1,2,2,C',C'] = K in fp32 serves every sample."""
    Kb = K.float()[None]
    if style is not None:
        Kb = Kb * style.float()[:, None, None, :, None]
    if demod is not None:
        Kb = Kb * demod.float()[:, None, None, None, :]
    return Kb


def conv2x2_variant(dtype: torch.dtype, C: int, shared: bool = False) -> str:
    """The kernel that s2d_conv2x2 launches, from x's dtype, its channels and
    whether one weight set serves every sample (csrc/s2d_conv2x2.cu):
    "wgmma" for bf16 with C' of 64 or 128 (TMA and wgmma, the weights
    resident in shared memory: every flagship launch, BigGAN-deep-512's last
    blocks); "wgmma_stream" for bf16 with C' = 256 and one shared set (the
    same, the weights streamed by TMA: BigGAN-deep's block 11); "wmma" for
    any other bf16 C' (TINY's 20, per-sample weights at 256, which no config
    runs); "fp32" for fp32."""
    if dtype == torch.float32:
        return "fp32"
    if C in (64, 128):
        return "wgmma"
    return "wgmma_stream" if C == 256 and shared else "wmma"


def conv2x2_weights(K, style, demod, dtype: torch.dtype, variant: str):
    """The kernel's weight operand: Kb (`_fold_style`, fp32) rounded once to
    `dtype`, [sets, 2, 2, C', C'] with sets = B, or 1 when style and demod
    are both None. The wgmma variants store each tap [out, in], the K-major
    B operand of wgmma; the others [in, out]. One pass: the copy rounds."""
    Kb = _fold_style(K, style, demod)
    if variant.startswith("wgmma"):
        Kb = Kb.transpose(-1, -2)
    return torch.empty(Kb.shape, dtype=dtype, device=Kb.device).copy_(Kb)


def s2d_conv2x2(x: torch.Tensor, K: torch.Tensor, style, demod,
                pad0: int) -> torch.Tensor:
    """The offset-lattice [2,2] conv of `s2d_conv2x2_plain` (style/demod
    [B,C'] or None for ones). CUDA: the hand-written kernel
    (csrc/s2d_conv2x2.cu) on x's dtype, the variant `conv2x2_variant` picks,
    with the weights from `conv2x2_weights`, differentiable as its plain
    version (`cuda.with_grad`); an unmodulated call (both None) hands it one
    weight set for every sample. CPU: `s2d_conv2x2_plain`; meta: the
    kernel's output (`cuda.dispatch`)."""
    return cuda.dispatch(x, _s2d_conv2x2_cuda, _s2d_conv2x2_meta, s2d_conv2x2_plain, x, K,
                         style, demod, pad0)


def _s2d_conv2x2_meta(x: torch.Tensor, K, style, demod, pad0: int) -> torch.Tensor:
    """The kernel's shape rule: [B, n +- 1, n +- 1, C'] in x's dtype."""
    B, n, _, C = x.shape
    n_out = n + 1 if pad0 else n - 1
    return torch.empty((B, n_out, n_out, C), dtype=x.dtype, device=x.device)


def _s2d_conv2x2_cuda(x: torch.Tensor, K: torch.Tensor, style, demod,
                      pad0: int) -> torch.Tensor:
    cuda.require_cuda("s2d_conv2x2", x, dtype=x.dtype)
    B, n, n2, C = x.shape
    scales = [t for t in (style, demod) if t is not None]
    if (n != n2 or tuple(K.shape) != (2, 2, C, C) or pad0 not in (0, 1)
            or any(tuple(t.shape) != (B, C) for t in scales)):
        raise ValueError(f"s2d_conv2x2: x {tuple(x.shape)}, K {tuple(K.shape)}, "
                         f"style/demod {[tuple(t.shape) for t in scales]}, pad0 {pad0}")
    for t in (K, *scales):
        if t.device != x.device:
            raise ValueError(f"s2d_conv2x2: tensors on {t.device} and {x.device}")
    variant = conv2x2_variant(x.dtype, C, shared=not scales)
    return conv2x2_launch(x, conv2x2_weights(K, style, demod, x.dtype, variant), pad0,
                          variant)


def conv2x2_launch(x: torch.Tensor, Kb: torch.Tensor, pad0: int,
                   variant: str) -> torch.Tensor:
    """Launch kernel variant `variant` on x and its weight operand Kb from
    `conv2x2_weights` (x checked by the caller); counts the launch."""
    B, n, _, C = x.shape
    n_out = n + 1 if pad0 else n - 1
    out = torch.empty((B, n_out, n_out, C), dtype=x.dtype, device=x.device)
    lib = cuda.library()
    if variant.startswith("wgmma") and any(t.data_ptr() % 16 for t in (x, Kb, out)):
        raise ValueError("s2d_conv2x2: the TMA kernel needs 16-byte aligned tensors")
    if variant == "wgmma_stream" and Kb.shape[0] != 1:
        raise ValueError("s2d_conv2x2: wgmma_stream takes one shared weight set")
    with cuda.launch_device(x):
        if variant == "wgmma":
            status = lib.cg_s2d_conv2x2_wgmma(
                x.data_ptr(), Kb.data_ptr(), out.data_ptr(), B, n, n_out, C, pad0,
                Kb.shape[0], cuda.stream_handle(x))
        elif variant == "wgmma_stream":
            status = lib.cg_s2d_conv2x2_wgmma_stream(
                x.data_ptr(), Kb.data_ptr(), out.data_ptr(), B, n, n_out, C, pad0,
                cuda.stream_handle(x))
        else:
            vec = cuda.vector_width(x.dtype, C, x, Kb, out)
            status = lib.cg_s2d_conv2x2(
                x.data_ptr(), Kb.data_ptr(), out.data_ptr(), B, n, n_out, C, pad0,
                Kb.shape[0], cuda.DTYPE_CODES[x.dtype], vec, cuda.stream_handle(x))
    cuda.check(status, "s2d_conv2x2")
    s2d_conv2x2.launches += 1
    s2d_conv2x2.launches_by_variant[variant] += 1
    return out


s2d_conv2x2.launches = 0
s2d_conv2x2.launches_by_variant = {"wgmma": 0, "wgmma_stream": 0, "wmma": 0, "fp32": 0}


def _takes_conv2x2(K: torch.Tensor, x: torch.Tensor) -> bool:
    """The dispatch rule of the JAX package: a [2,2] fold with square
    channels equal to the input's, unless it is a call site of an active
    calibration or int8 scope (ops/quant.py). Such a fold takes the JAX
    package's default form instead, the one its int8 mode quantizes: the
    style scales the input, the fold (rounded to the activation dtype) runs
    as a `_conv`, demod scales the output."""
    return (K.shape[0] == 2 and K.shape[2] == K.shape[3] == x.shape[-1]
            and not quant.hooked((K.shape[3], K.shape[2], 2, 2)))


# ------------------------------------------------------------ modulated ops


def s2d_modulated_conv2d(x_s2d, w, style, *, demodulate: bool = True,
                         eps: float = 1e-8, in_off: int = 0, out_off: int = 0):
    """modulated_conv2d on an s2d tensor. x_s2d: [B,nh,nw,4I] at lattice
    `in_off`; w: [O,I,k,k] (the original kernel); style: [B,I]. Exact: the
    input scaling and output demodulation tile per phase; the spatial kernel
    folds onto the lattice pair. A [2,2] fold runs `s2d_conv2x2`."""
    Kp, pad0 = s2d_same_kernel(w, in_off, out_off)
    if _takes_conv2x2(Kp, x_s2d):
        d = tile_channels(demod_coef(w, style, eps)) if demodulate else None
        return s2d_conv2x2(x_s2d.contiguous(), Kp, tile_channels(style), d, pad0)
    n_out = n_cells(phys_size(x_s2d.shape[1], in_off), out_off)
    pad1 = _pad1_for(x_s2d.shape[1], n_out, Kp.shape[0], 1, pad0)
    xs = x_s2d * tile_channels(style).to(x_s2d.dtype)[:, None, None, :]
    y = _conv_hwio(xs, Kp, pad0=pad0, pad1=pad1)
    if demodulate:
        y = y * tile_channels(demod_coef(w, style, eps)).to(y.dtype)[:, None, None, :]
    return y


def s2d_modulated_conv2d_up(x, w, style, *, demodulate: bool = True,
                            filter_taps=(1, 3, 3, 1), eps: float = 1e-8,
                            input_s2d: bool = False, in_off: int = 0):
    """modulated_conv2d_up straight into s2d form (output lattice offset 0).

    input_s2d=False: x [B,H,W,I] plain -> [B,H,W,4O] (= s2d of 2H x 2W).
    input_s2d=True:  x s2d at lattice `in_off` -> [B,H,W,4O] via a
    lhs_dilation=2 conv at the physical level (the s2d(H) -> s2d(2H) up
    transition)."""
    if input_s2d:
        Kd, pad0 = s2d_up_kernel_from_s2d(w, filter_taps, in_off)
        n_in = x.shape[1]
        n_out = phys_size(n_in, in_off)  # cells of s2d(2H) at offset 0
        pad1 = _pad1_for(2 * n_in - 1, n_out, 4, 1, pad0)  # dilated length
        xs = x * tile_channels(style).to(x.dtype)[:, None, None, :]
        y = _conv_hwio(xs, Kd, pad0=pad0, pad1=pad1, lhs_dilation=2)
    else:
        Kp, pad0 = s2d_up_kernel(w, filter_taps)
        xs = x * style[:, None, None, :].to(x.dtype)
        y = _conv_hwio(xs, Kp, pad0=pad0, pad1=pad0)
    if demodulate:
        y = y * tile_channels(demod_coef(w, style, eps)).to(y.dtype)[:, None, None, :]
    return y


def s2d_conv2d(x_s2d, w, in_off: int = 0, out_off: int = 0):
    """Unmodulated stride-1 'SAME' conv on an s2d tensor (D fromRGB/conv0).
    A [2,2] fold runs `s2d_conv2x2` with one weight set for every sample
    (style and demod None)."""
    Kp, pad0 = s2d_same_kernel(w, in_off, out_off)
    if _takes_conv2x2(Kp, x_s2d):
        return s2d_conv2x2(x_s2d.contiguous(), Kp, None, None, pad0)
    n_out = n_cells(phys_size(x_s2d.shape[1], in_off), out_off)
    pad1 = _pad1_for(x_s2d.shape[1], n_out, Kp.shape[0], 1, pad0)
    return _conv_hwio(x_s2d, Kp, pad0=pad0, pad1=pad1)


def s2d_conv2d_down(x_s2d, w, *, filter_taps=(1, 3, 3, 1),
                    output_s2d: bool = False, in_off: int = 0,
                    out_off: int = 0):
    """FIR + stride-2 conv on an s2d input -> half-res output, PLAIN
    (default) or s2d (the level below also runs in the s2d domain)."""
    Kp, pad0, stride = s2d_down_kernel(w, filter_taps, out_s2d=output_s2d,
                                       in_off=in_off, out_off=out_off)
    H = phys_size(x_s2d.shape[1], in_off)  # input physical resolution
    n_out = n_cells(H // 2, out_off) if output_s2d else H // 2
    pad1 = _pad1_for(x_s2d.shape[1], n_out, Kp.shape[0], stride, pad0)
    return _conv_hwio(x_s2d, Kp, stride=stride, pad0=pad0, pad1=pad1)


# ------------------------------------------------------------ BigGAN ops
#
# BigGAN-deep's bottleneck blocks run mid = in/4 channels at 256-512 px. The
# mid segment (conv0 1x1 -> [nearest up] -> conv1 3x3 -> conv2 3x3 -> conv3
# 1x1) maps onto the s2d domain with no standalone layout transposes: conv0
# folds plain -> s2d, the nearest-neighbour upsample composes into conv1, and
# conv3 folds s2d -> plain (with the block's nearest-up residual fused into
# it in up blocks). Weights: OIHW, in the compute dtype.


def s2d_enter_conv1x1(x_plain, w, out_off: int = 0):
    """1x1 conv [I -> O] from a PLAIN tensor straight into s2d form at
    lattice `out_off`: a stride-2 conv with the per-phase kernel. w:
    [O, I, 1, 1]. Exact."""
    assert w.shape[2] == w.shape[3] == 1
    Kp, pad0, kh = _fold(_hwio(w), 0, 1, False, True, 0, out_off)
    H = x_plain.shape[1]
    pad1 = _pad1_for(H, n_cells(H, out_off), kh, 2, pad0)
    return _conv_hwio(x_plain, Kp, stride=2, pad0=pad0, pad1=pad1)


def _exit_kernel(w, extra: int = 0):
    """[2,2,4I+extra,O] HWIO fp32 kernel of the s2d -> plain 1x1 exit: the
    dilated tap (1-rjh, 1-rjw) reads phase (rjh, rjw) (the pad0 = 1 + in_off
    that the exits use puts each phase's tap there at either offset)."""
    O, I = w.shape[:2]
    w32 = w[:, :, 0, 0].t().float()
    K = torch.zeros((2, 2, 4 * I + extra, O), device=w.device)
    for rjh in range(2):
        for rjw in range(2):
            ci = (rjh * 2 + rjw) * I
            K[1 - rjh, 1 - rjw, ci:ci + I] = w32
    return K


def s2d_exit_conv1x1(x_s2d, w, in_off: int = 0):
    """1x1 conv [I -> O] from an s2d tensor (lattice `in_off`) back to PLAIN
    full resolution: a lhs_dilation=2 conv whose [2,2] taps pick the phase
    of each output pixel. w: [O, I, 1, 1]. Exact."""
    assert w.shape[2] == w.shape[3] == 1
    pad0 = 1 + in_off
    n_in = x_s2d.shape[1]
    pad1 = _pad1_for(2 * n_in - 1, phys_size(n_in, in_off), 2, 1, pad0)
    return _conv_hwio(x_s2d, _exit_kernel(w), pad0=pad0, pad1=pad1, lhs_dilation=2)


@lru_cache(maxsize=None)
def _nearest_up_fold_map(kh: int, in_off: int, out_off: int = 0):
    """Mapping tensor M[tau, a, rj, rv] of conv(k=kh, pad (kh-1)//2, the
    BigGAN convention) composed with a 2x NEAREST upsample of its input,
    from s2d(H, in_off) to s2d(2H, out_off) as a lhs_dilation=2 conv:
    y[2v'+oo+rv] = sum_a K[a] x_up[2v'+oo+rv+a-p0], x_up[i] = x_plain[i//2].
    Both phases of an input cell appear, each at its own dilated tap.
    Returns (M, pad0)."""
    p0 = (kh - 1) // 2
    entries = []
    for rv in range(2):
        for a in range(kh):
            du = (out_off + rv + a - p0) // 2   # + v' (the 2v' term floors away)
            for rj in range(2):
                entries.append((du, rj, rv, a))
    taus = [du - in_off - rj for (du, rj, _, _) in entries]
    tmin = min(taus)
    M = np.zeros((max(taus) - tmin + 1, kh, 2, 2), np.float32)
    for (du, rj, rv, a) in entries:
        M[du - in_off - rj - tmin, a, rj, rv] += 1.0
    return M, -tmin


def _nearest_up_fold_matrix(*args):
    return _nearest_up_fold_map(*args)[0]


def s2d_nearest_up_conv(x_s2d, w, in_off: int = 0, out_off: int = 0):
    """conv2d 'SAME' (pad (k-1)//2) of the 2x NEAREST-upsampled input, from
    the s2d input straight to the s2d(2H, out_off) output as one
    lhs_dilation=2 conv. w: [O, I, k, k]. Exact. out_off=-1 emits phantom
    cells (garbage until mask_phantoms_): the first link of the up blocks'
    offset chain 0 -> -1 -> 0."""
    kh = w.shape[-1]
    _, pad0 = _nearest_up_fold_map(kh, in_off, out_off)
    M = constant(_nearest_up_fold_matrix, kh, in_off, out_off, device=w.device)
    K = _hwio(w)
    Kp = torch.einsum("DaJR,EbKS,abio->DEJKiRSo", M, M, K)
    kt = Kp.shape[0]
    Kp = Kp.reshape(kt, kt, 4 * K.shape[2], 4 * K.shape[3])
    n_in = x_s2d.shape[1]
    n_out = n_cells(2 * phys_size(n_in, in_off), out_off)
    pad1 = _pad1_for(2 * n_in - 1, n_out, kt, 1, pad0)
    return _conv_hwio(x_s2d, Kp, pad0=pad0, pad1=pad1, lhs_dilation=2)


def s2d_exit_conv1x1_skip(x_s2d, w, skip, in_off: int = 0):
    """s2d_exit_conv1x1 with the up block's residual fused in: returns
    plain(conv1x1(x_s2d)) + nearest_up_2x(skip) as ONE lhs_dilation=2 conv.
    skip: [B, n, n, O] at the pre-up resolution, which at in_off = 0 is the
    cell lattice of x_s2d; it is concatenated onto the s2d channels and the
    kernel carries identity taps at all four [2,2] positions, of which the
    dilation zeros select the containing cell per output pixel. Exact;
    in_off must be 0 (at -1 a cell's two rows straddle two skip cells)."""
    assert in_off == 0, "skip fusion requires the offset-0 exit lattice"
    O = w.shape[0]
    assert w.shape[2] == w.shape[3] == 1 and skip.shape[-1] == O
    K = _exit_kernel(w, O)
    eye = torch.eye(O, device=w.device)
    for rjh in range(2):
        for rjw in range(2):
            K[rjh, rjw, -O:] = eye
    xin = torch.cat([x_s2d, skip.to(x_s2d.dtype)], dim=-1)
    n_in = x_s2d.shape[1]
    pad1 = _pad1_for(2 * n_in - 1, phys_size(n_in, 0), 2, 1, 1)
    return _conv_hwio(xin, K, pad0=1, pad1=pad1, lhs_dilation=2)


# ------------------------------------------------------------ s4d RGB domain
#
# The RGB/skip-accumulator path carries C = 3 channels. At the s2d levels it
# is packed 4x4 (s4d: [B, H/4, W/4, 16C], phase-major with channel
# (rp*4+cp)*C + c). ToRGB lands s2d -> s4d, the FIR skip upsample runs
# s4d -> s4d, the 224 px resize contracts the 16 phases and D's fromRGB folds
# s4d -> s2d. s4d tensors are at lattice offset 0: no phantoms.


def s4d(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/4, W/4, 16C], phase-major (rp*4+cp)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // 4, 4, W // 4, 4, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H // 4, W // 4, 16 * C)


def un_s4d(x: torch.Tensor) -> torch.Tensor:
    """[B, H/4, W/4, 16C] -> [B, H, W, C] (inverse of s4d)."""
    B, Hq, Wq, C16 = x.shape
    C = C16 // 16
    x = x.reshape(B, Hq, Wq, 4, 4, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, 4 * Hq, 4 * Wq, C)


def s2d_to_s4d(x_s2d: torch.Tensor) -> torch.Tensor:
    """Repack an offset-0 s2d tensor [B, H/2, W/2, 4C] as s4d
    [B, H/4, W/4, 16C]: s4d phase rp splits as (jr, r2) = (rp//2, rp%2)."""
    B, n, m, C4 = x_s2d.shape
    C = C4 // 4
    x = x_s2d.reshape(B, n // 2, 2, m // 2, 2, 2, 2, C)
    # dims: B, q1, jr, q2, kr, r2, c2, C -> B, q1, q2, (jr, r2, kr, c2), C
    x = x.permute(0, 1, 3, 2, 5, 4, 6, 7)
    return x.reshape(B, n // 2, m // 2, 16 * C)


def s4d_from_s2d_conv1x1(x_s2d, w, in_off: int = 0):
    """1x1 conv [I -> O] from an s2d tensor (lattice `in_off`) straight to
    s4d(0): per output phase rp the source row is s2d cell (4v''+rp-oi)//2,
    phase (4v''+rp-oi)%2: a stride-2 conv whose taps select the (cell, phase)
    per output phase. w: the ToRGB matrix [I, O]. Exact."""
    I, O = w.shape
    w32 = w.float()
    taus = [(rp - in_off) // 2 for rp in range(4)]
    rjs = [(rp - in_off) % 2 for rp in range(4)]
    kh = max(taus) + 1
    K = torch.zeros((kh, kh, 4 * I, 16 * O), device=w.device)
    for rp in range(4):
        for cp in range(4):
            ci = (rjs[rp] * 2 + rjs[cp]) * I
            co = (rp * 4 + cp) * O
            K[taus[rp], taus[cp], ci:ci + I, co:co + O] = w32
    n_in = x_s2d.shape[1]
    n_out = phys_size(n_in, in_off) // 4
    pad1 = _pad1_for(n_in, n_out, kh, 2, 0)
    return _conv_hwio(x_s2d, K, stride=2, pad0=0, pad1=pad1)


@lru_cache(maxsize=None)
def _s4d_up_map(filter_taps: tuple, gain: float):
    """Fold of the FIR 2x upsample from s4d(H, 0) to s4d(2H, 0) as a
    lhs_dilation=2 conv over cells: out full row m = 4v''+rv = 2p+rm;
    Y[m] = sum_dj k2[2dj+1-rm] X[p+dj-1]; the input pixel u = 2v'' + rv//2 +
    dj - 1 maps to cell u//4, phase u%4, with the cell arithmetic depending
    on v'' parity: both parities get their own tap slots, and the dilation
    zeros mask the mismatched one. Returns (M[t, pu, rv], pad0)."""
    k1 = np.asarray(filter_taps, np.float64)
    k1 = k1 / k1.sum() * np.sqrt(float(gain)) * 2.0  # separable 1-D factor
    entries = {}
    pad0 = 2
    for parity in (0, 1):        # v'' = 2w + parity
        for rv in range(4):
            rm = rv % 2
            for dj in (0, 1):
                coef = float(k1[2 * dj + 1 - rm])
                if coef == 0.0:
                    continue
                delta = rv // 2 + dj - 1
                u_base = 2 * parity + delta      # u - 4w
                c_rel = u_base // 4              # cell - w
                pu = u_base % 4
                tau = 2 * c_rel - parity + pad0  # dilated tap index
                key = (tau, pu, rv)
                entries[key] = entries.get(key, 0.0) + coef
    kt = max(t for (t, _, _) in entries) + 1
    M = np.zeros((kt, 4, 4), np.float32)
    for (t, pu, rv), coef in entries.items():
        M[t, pu, rv] = coef
    return M, pad0


def _s4d_up_kernel(filter_taps: tuple, gain: float, C: int):
    M, _ = _s4d_up_map(filter_taps, gain)
    kt = M.shape[0]
    # K[t1, t2, (pu1*4+pu2)*C+c, (rv1*4+rv2)*C+c]
    K = np.einsum("tpr,uqs,cd->tupqcrsd", M, M, np.eye(C, dtype=np.float32))
    return K.reshape(kt, kt, 16 * C, 16 * C)


def s4d_upsample2x(y: torch.Tensor, filter_taps=(1, 3, 3, 1),
                   gain: float = 1.0) -> torch.Tensor:
    """upsample2x on an s4d tensor: [B, H/4, W/4, 16C] -> [B, H/2, W/2, 16C]
    (physical 2x). Exact."""
    taps = tuple(filter_taps)
    _, pad0 = _s4d_up_map(taps, float(gain))
    K = constant(_s4d_up_kernel, taps, float(gain), y.shape[-1] // 16,
                 device=y.device, dtype=y.dtype)
    n_in = y.shape[1]
    pad1 = _pad1_for(2 * n_in - 1, 2 * n_in, K.shape[0], 1, pad0)
    return _conv_hwio(y, K, pad0=pad0, pad1=pad1, lhs_dilation=2)


@lru_cache(maxsize=None)
def _plain_to_s4d_up_taps(filter_taps: tuple, gain: float):
    """1-D polyphase map M[t, pu] of the FIR 2x upsample read directly in s4d
    phase coordinates: output pixel m = 4w + pu = 2v + rv reads plain input
    u = 2w + (pu//2 - 1 + dj) with tap k1[2dj+1-rv], dj in {0,1}: a width-3
    stride-2 window (t = pu//2 + dj, pad 1)."""
    k1 = np.asarray(filter_taps, np.float64)
    k1 = k1 / k1.sum() * np.sqrt(float(gain)) * 2.0
    M = np.zeros((3, 4), np.float64)
    for pu in range(4):
        for dj in (0, 1):
            M[pu // 2 + dj, pu] += float(k1[2 * dj + 1 - (pu % 2)])
    return M


def _plain_to_s4d_up_kernel(filter_taps: tuple, gain: float, C: int):
    M = _plain_to_s4d_up_taps(filter_taps, gain).astype(np.float32)
    # K[t1, t2, c, (pu_row*4 + pu_col)*C + c]  (s4d phase-major layout)
    K = np.einsum("tp,uq,cd->tucpqd", M, M, np.eye(C, dtype=np.float32))
    return K.reshape(3, 3, C, 16 * C)


def plain_to_s4d_upsample2x(y: torch.Tensor, filter_taps=(1, 3, 3, 1),
                            gain: float = 1.0) -> torch.Tensor:
    """upsample2x from a PLAIN [B, H, W, C] tensor straight into the s4d
    domain at 2x physical resolution: [B, H/2, W/2, 16C], one stride-2
    [3,3,C,16C] conv. Exact."""
    K = constant(_plain_to_s4d_up_kernel, tuple(filter_taps), float(gain),
                 y.shape[-1], device=y.device, dtype=y.dtype)
    return _conv_hwio(y, K, stride=2, pad0=1, pad1=1)


def s2d_from_s4d_conv1x1(y_s4d, w, out_off: int = 0):
    """1x1 conv [I -> O] from an s4d(0) tensor to an s2d tensor at lattice
    `out_off` (the D fromRGB entry): out row m = 2v'+rp+oo reads s4d cell
    m//4, phase m%4: a lhs_dilation=2 conv over cells. w: [O, I, 1, 1].
    Exact."""
    O, I = w.shape[:2]
    w32 = w[:, :, 0, 0].t().float()
    pad0 = 2
    entries = {}
    for parity in (0, 1):   # out cell v' = 2w + parity
        for rp in range(2):
            m_base = 2 * parity + rp + out_off   # m - 4w
            tau = 2 * (m_base // 4) - parity + pad0
            entries[(tau, m_base % 4, rp, parity)] = 1.0
    kt = max(t for (t, _, _, _) in entries) + 1
    K = torch.zeros((kt, kt, 16 * I, 4 * O), device=w.device)
    for (t1, pu1, rp1, _) in entries:
        for (t2, pu2, rp2, _) in entries:
            ci = (pu1 * 4 + pu2) * I
            co = (rp1 * 2 + rp2) * O
            K[t1, t2, ci:ci + I, co:co + O] = w32
    n_in = y_s4d.shape[1]
    n_out = n_cells(4 * n_in, out_off)
    pad1 = _pad1_for(2 * n_in - 1, n_out, kt, 1, pad0)
    return _conv_hwio(y_s4d, K, pad0=pad0, pad1=pad1, lhs_dilation=2)


# ------------------------------------------------------------ resize


def _phase_matrix(src: int, dst: int, phases: int, in_off: int):
    """The bilinear weights [dst, src] with the source index split as
    (cell, phase): [dst, cells, phases]; an offset -1 lattice gets zero
    weight columns for its phantom rows -1 and H."""
    R = bilinear_matrix(src, dst)
    if in_off:
        R = np.pad(R, ((0, 0), (1, 1)))
    return R.reshape(dst, -1, phases)


def _resize_packed(img, R_h, R_w, phases: int):
    """Contract the packed rows, then the packed columns, in fp32 from
    source-dtype operands, rounding the intermediate to the source dtype
    (as the JAX package's two preferred_element_type=fp32 einsums)."""
    B, n, m, Cp = img.shape
    C = Cp // (phases * phases)
    dt = img.dtype
    x = img.reshape(B, n, m, phases, phases, C).float()
    t = torch.einsum("bpqrsc,opr->boqsc", x, R_h.to(dt).float())
    z = torch.einsum("boqsc,wqs->bowc", t.to(dt).float(), R_w.to(dt).float())
    return z.permute(0, 3, 1, 2)


def resize_bilinear_from_s4d(img_s4d: torch.Tensor, size: int = 224):
    """[B, H/4, W/4, 16C] s4d image -> [B, C, size, size] fp32 (NCHW): the
    bilinear weight matrix folds the 4-phase index per dimension."""
    _, Hq, Wq, _ = img_s4d.shape
    dev = img_s4d.device
    R_h = constant(_phase_matrix, 4 * Hq, size, 4, 0, device=dev)
    R_w = constant(_phase_matrix, 4 * Wq, size, 4, 0, device=dev)
    return _resize_packed(img_s4d, R_h, R_w, 4)


def resize_bilinear_from_s2d(img_s2d: torch.Tensor, size: int = 224,
                             in_off: int = 0):
    """[B, nh, nw, 4C] s2d image (lattice `in_off`) -> [B, C, size, size]
    fp32 (NCHW, the semantics of ops/resize.resize_bilinear) without making
    the full-res image; phantom rows get zero weight."""
    _, Hh, Wh, _ = img_s2d.shape
    dev = img_s2d.device
    R_h = constant(_phase_matrix, phys_size(Hh, in_off), size, 2, in_off, device=dev)
    R_w = constant(_phase_matrix, phys_size(Wh, in_off), size, 2, in_off, device=dev)
    return _resize_packed(img_s2d, R_h, R_w, 2)
