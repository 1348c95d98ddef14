"""Multi-head attention, einsum formulation.

Matches torch nn.MultiheadAttention's eager math as the reference CLIP blocks
use it (reference clip/model.py:164-187): fused QKV in-projection,
1/sqrt(head_dim) scaling, additive mask, fp32 softmax, output projection.
Weights are right-multiply ([D, 3D] and [D, D]) like the JAX package's, so
the numbers follow it step for step.

On a model shard (parallel.mesh.shard_clip_tp) the weights hold the
shard's heads only: the in-projection [D, 3D/tp] (its heads of q, k and
v), out_proj's rows [D/tp, D]; the output projection is then a partial
product that `project` sums over the model group before its bias.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from clip_glass_torch.core.dtypes import FP32, Policy


def project(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor, policy: Policy,
            reduce: Optional[Callable] = None) -> torch.Tensor:
    """h @ w + b in the compute dtype. With `reduce` (a model shard's sum
    over its group: h and w hold a slice of the contraction) the partial
    product of the compute-dtype operands is taken with an fp32 result and
    summed in fp32, rounded once to the compute dtype (as the whole
    matmul's fp32 accumulator is), and the bias added once, after the
    sum."""
    w = policy.cast_compute(w)
    if reduce is None:
        return h @ w + policy.cast_compute(b)
    part = reduce(_fp32_product(h, w))
    return policy.cast_compute(part) + policy.cast_compute(b)


def _fp32_product(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h @ w with an fp32 result. bf16 operands on a card stay on the
    tensor cores with fp32 accumulation (`torch.mm`'s out_dtype, which
    the CPU lacks; on meta it allocates the card's output alone);
    otherwise the operands widen to fp32, exactly."""
    if h.dtype == w.dtype == torch.bfloat16 and h.device.type in ("cuda", "meta"):
        flat = torch.mm(h.reshape(-1, h.shape[-1]), w, out_dtype=torch.float32)
        return flat.reshape(*h.shape[:-1], w.shape[-1])
    return h.float() @ w.float()


def multi_head_attention(x: torch.Tensor, in_proj_w, in_proj_b, out_proj_w,
                         out_proj_b, n_head: int,
                         mask: Optional[torch.Tensor] = None,
                         policy: Policy = FP32,
                         reduce: Optional[Callable] = None) -> torch.Tensor:
    """x: [B, T, D]; in_proj_w: [D, 3D']; out_proj_w: [D', D], where D' = D
    for the whole layer and D/tp for a model shard of its heads (`n_head`:
    the heads the weights hold; `reduce`: the shard's sum over its group)."""
    B, T, _ = x.shape
    width = in_proj_w.shape[-1] // 3    # the heads' width this layer holds
    hd = width // n_head
    qkv = x @ policy.cast_compute(in_proj_w) + policy.cast_compute(in_proj_b)
    q, k, v = qkv.split(width, dim=-1)

    def heads(t):
        return t.reshape(B, T, n_head, hd).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    # logits in fp32 (bf16 products are exact in fp32)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (hd ** -0.5)
    if mask is not None:
        logits = logits + mask.float()
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", w, v)
    out = out.transpose(1, 2).reshape(B, T, width)
    return project(out, out_proj_w, out_proj_b, policy, reduce)
