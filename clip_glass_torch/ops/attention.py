"""Multi-head attention, einsum formulation.

Matches torch nn.MultiheadAttention's eager math as the reference CLIP blocks
use it (reference clip/model.py:164-187): fused QKV in-projection,
1/sqrt(head_dim) scaling, additive mask, fp32 softmax, output projection.
Weights are right-multiply ([D, 3D] and [D, D]) like the JAX package's, so
the numbers follow it step for step.
"""

from __future__ import annotations

from typing import Optional

import torch

from clip_glass_torch.core.dtypes import FP32, Policy


def multi_head_attention(x: torch.Tensor, in_proj_w, in_proj_b, out_proj_w,
                         out_proj_b, n_head: int,
                         mask: Optional[torch.Tensor] = None,
                         policy: Policy = FP32) -> torch.Tensor:
    """x: [B, T, D]; in_proj_w: [D, 3D]; out_proj_w: [D, D]."""
    B, T, D = x.shape
    hd = D // n_head
    qkv = x @ policy.cast_compute(in_proj_w) + policy.cast_compute(in_proj_b)
    q, k, v = qkv.split(D, dim=-1)

    def heads(t):
        return t.reshape(B, T, n_head, hd).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    # logits in fp32 (bf16 products are exact in fp32)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (hd ** -0.5)
    if mask is not None:
        logits = logits + mask.float()
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", w, v)
    out = out.transpose(1, 2).reshape(B, T, D)
    return out @ policy.cast_compute(out_proj_w) + policy.cast_compute(out_proj_b)
