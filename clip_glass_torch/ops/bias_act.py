"""Bias + activation + gain, minibatch-std, and the fused synthesis epilogue.

Behavioral reference: stylegan2/modules.py:227-300 (BiasActivationWrapper),
the activation gain table at modules.py:7-55 (lrelu gain = sqrt(2)) and
modules.py:679-750 (minibatch std). Tensors are NHWC, channels last.

`noise_bias_lrelu` is the wrapper of the hand-written CUDA kernel
(csrc/noise_bias_lrelu.cu): a CUDA tensor launches the kernel, a CPU tensor
takes the plain version `noise_bias_lrelu_plain`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from clip_glass_torch.ops import cuda

SQRT2 = math.sqrt(2.0)


def bias_act(x: torch.Tensor, bias=None, act: str = "linear",
             gain: float = None, alpha: float = 0.2) -> torch.Tensor:
    """x: [..., C] channel-last. act in {'linear', 'lrelu'}."""
    if bias is not None:
        x = x + bias.to(x.dtype)
    if act == "lrelu":
        x = F.leaky_relu(x, alpha)
        if gain is None:
            gain = SQRT2
    if gain is not None and gain != 1.0:
        # the gain is rounded to x's dtype first, as the JAX package does
        x = x * torch.tensor(gain, dtype=x.dtype)
    return x


def minibatch_std(x: torch.Tensor, group_size: int = 4, eps: float = 1e-8,
                  center_input: bool = True, n_search: int = 1, mesh=None) -> torch.Tensor:
    """Minibatch-std extra channel (reference stylegan2/modules.py:679-750).
    x: [B, H, W, C] -> [B, H, W, C+1]; stats in fp32.

    `center_input=True` reproduces the reference's fp32 quirk: the in-place
    `y -= y.mean(dim=0)` at modules.py:728 aliases the input storage, so the
    features concatenated at modules.py:745 are CENTERED by their group mean.
    Groups are `reshape(g, B//g, ...)`; batch b gets the std of s[b mod B/g].

    `n_search`: the batch is that many searches' populations, each a
    consecutive block of B/n_search rows, and the groups form inside each
    block (the JAX package gets the same from `vmap` over searches): no row
    is pooled with another search's. With 1 the blocks are the batch.

    `mesh` (parallel.mesh.Mesh): x is this shard's row block of a batch
    split over the mesh. The groups are strided (row b pools with rows
    b + k*B/g), so a split changes them; as GSPMD does in the JAX package,
    the rows are gathered (`gather_rows`, differentiable across ranks), the
    groups formed over the whole batch (n_search blocks of it), the
    centered features taken from the global group means too, and this
    shard's rows kept.
    """
    if mesh is not None and mesh.dp > 1:
        from clip_glass_torch.parallel.mesh import gather_rows, own_rows

        full = minibatch_std(gather_rows(x, mesh), group_size, eps, center_input, n_search)
        return own_rows(full, x.shape[0], mesh)
    B, H, W, C = x.shape
    n = B // n_search                                # rows of one search
    g = group_size if group_size and group_size > 0 else n
    y = x.float().reshape(n_search, g, n // g, H, W, C)
    y = y - y.mean(dim=1, keepdim=True)
    s = torch.sqrt(y.square().mean(dim=1) + eps)
    s = s.reshape(n_search, n // g, -1).mean(dim=-1)  # [n_search, n/g]
    s = s.repeat(1, g).reshape(B).to(x.dtype)        # row b of a block: s[b mod n/g]
    s = s[:, None, None, None].expand(B, H, W, 1)
    if center_input:
        x = y.reshape(B, H, W, C).to(x.dtype)
    return torch.cat([x, s], dim=-1)


def noise_bias_lrelu_plain(x: torch.Tensor, noise: torch.Tensor,
                           noise_scale: torch.Tensor, bias: torch.Tensor,
                           alpha: float = 0.2, gain: float = SQRT2) -> torch.Tensor:
    """lrelu(x + ns * noise[h, w] + bias[c]) * gain in fp32, rounded once to
    x's dtype. x: [B, H, W, C]; noise: [H, W]; noise_scale: scalar; bias: [C]."""
    v = x.float() + noise_scale.float() * noise.float()[None, :, :, None] + bias.float()
    v = torch.where(v >= 0, v, alpha * v)
    return (v * gain).to(x.dtype)


def noise_bias_lrelu(x: torch.Tensor, noise: torch.Tensor,
                     noise_scale: torch.Tensor, bias: torch.Tensor,
                     alpha: float = 0.2, gain: float = SQRT2) -> torch.Tensor:
    """Fused noise injection + bias + leaky ReLU + gain. CUDA: the
    hand-written kernel (noise, scale and bias in x's dtype; the scale stays
    on the device), differentiable as its plain version (`cuda.with_grad`);
    CPU: `noise_bias_lrelu_plain`; meta: the kernel's output (`cuda.dispatch`)."""
    return cuda.dispatch(x, _noise_bias_lrelu_cuda, _noise_bias_lrelu_meta,
                         noise_bias_lrelu_plain, x, noise, noise_scale, bias, alpha, gain)


def _noise_bias_lrelu_meta(x, noise, noise_scale, bias, alpha, gain) -> torch.Tensor:
    """The kernel's shape rule: its output, x's shape and dtype."""
    return torch.empty_like(x)


def _noise_bias_lrelu_cuda(x: torch.Tensor, noise: torch.Tensor,
                            noise_scale: torch.Tensor, bias: torch.Tensor,
                            alpha: float, gain: float) -> torch.Tensor:
    """Check the operands and launch the kernel; counts the launch."""
    cuda.require_cuda("noise_bias_lrelu", x, noise, noise_scale, bias,
                      dtype=x.dtype)
    B, H, W, C = x.shape
    if noise.shape != (H, W) or noise_scale.numel() != 1 or bias.shape != (C,):
        raise ValueError(f"noise_bias_lrelu: shapes x {tuple(x.shape)}, noise "
                         f"{tuple(noise.shape)}, scale {tuple(noise_scale.shape)}, "
                         f"bias {tuple(bias.shape)}")
    out = torch.empty_like(x)
    vec = cuda.vector_width(x.dtype, C, x, bias, out)
    lib = cuda.library()
    with cuda.launch_device(x):
        status = lib.cg_noise_bias_lrelu(
            x.data_ptr(), noise.data_ptr(), noise_scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), x.numel(), H * W, C, alpha, gain,
            cuda.DTYPE_CODES[x.dtype], vec, cuda.stream_handle(x))
    cuda.check(status, "noise_bias_lrelu")
    noise_bias_lrelu.launches += 1
    return out


noise_bias_lrelu.launches = 0
