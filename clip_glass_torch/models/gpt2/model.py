"""GPT-2 (124M) language model with a preallocated KV cache and argmax decode.

Behavioral reference: reference gpt2/model.py (tanh-GELU 12-13, TF LayerNorm
15-28, Conv1D 30-43, scaled causal attention with `w*b - 1e10*(1-b)` masking
45-95, tied LM head 194-212) and the autoregressive loop of
gpt2/sample.py:21-36 (temperature, top-k, argmax when sample=False: the
CLIP-GLaSS setting, reference config.py:19). The numbers follow the JAX
package's formulation (clip_glass_tpu/models/gpt2/model.py).

Design:
- Parameters are plain trees: `wte`, `wpe`, `ln_f` and a list of per-layer
  blocks, Conv1D weights right-multiply [in, out] as in the checkpoints.
- The decode writes into a preallocated per-layer cache [2, B, H, T_max, hd]
  in the compute dtype: prefill fills positions [0, T0), each decode step
  writes one slot in place. Every tensor of a step has a fixed shape (no
  growing `past`), and the loop has no host sync, so a step can be captured
  as a CUDA graph.
- A decode step reads the cache without changing it while attending: the new
  token's own key is scored apart, stale slots (>= pos_offset) are masked by
  `w*mask + NEG_BIG*(1-mask)` (not -inf: a fully masked row stays a uniform
  row, not NaN), and one fp32 softmax runs over [cache | new].
- LayerNorm statistics and attention logits are fp32; matmuls run in the
  compute dtype.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from clip_glass_torch.core.dtypes import FP32, Policy, precast_params
from clip_glass_torch.weights import from_jax

NEG_BIG = -1e10

# leaves the forward reads raw in fp32: the LayerNorm gains and biases
PRECAST_EXCLUDE = ("ln_",)


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5


GPT2_124M = GPT2Config()
TINY = GPT2Config(vocab_size=50257, n_positions=128, n_embd=64, n_layer=2, n_head=2)


# ---------------------------------------------------------------- init

def _randn(gen, *shape):
    return torch.randn(shape, generator=gen, device=gen.device)


def init_tree(gen: torch.Generator, cfg: GPT2Config = GPT2_124M, std: float = 0.02):
    """Random parameters (the JAX package's distributions: N(0, std) weights,
    zero biases, unit LayerNorm gains) in the JAX layout, blocks stacked on a
    leading layer axis (what a converted GPT-2 `.npz` holds)."""
    D = cfg.n_embd

    def ln():
        return {"g": torch.ones(D), "b": torch.zeros(D)}

    wte = std * _randn(gen, cfg.vocab_size, D)
    wpe = std * _randn(gen, cfg.n_positions, D)
    blocks = []
    for _ in range(cfg.n_layer):
        blocks.append({
            "ln_1": ln(),
            "attn": {"c_attn_w": std * _randn(gen, D, 3 * D), "c_attn_b": torch.zeros(3 * D),
                     "c_proj_w": std * _randn(gen, D, D), "c_proj_b": torch.zeros(D)},
            "ln_2": ln(),
            "mlp": {"c_fc_w": std * _randn(gen, D, 4 * D), "c_fc_b": torch.zeros(4 * D),
                    "c_proj_w": std * _randn(gen, 4 * D, D), "c_proj_b": torch.zeros(D)},
        })

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)

    return {"wte": wte, "wpe": wpe, "blocks": stack(blocks), "ln_f": ln()}


def init(gen: torch.Generator, cfg: GPT2Config = GPT2_124M, std: float = 0.02):
    """Random parameters in the port's layout."""
    return from_jax.convert_gpt2(init_tree(gen, cfg, std))


# ---------------------------------------------------------------- forward

def _ln(x, p, eps):
    """LayerNorm with fp32 statistics and the raw fp32 gain and bias, back in
    x's dtype: the JAX package's `_ln` (mean, biased variance, rsqrt)."""
    return F.layer_norm(x.float(), x.shape[-1:], p["g"].float(), p["b"].float(),
                        eps).to(x.dtype)


def _gelu(x):
    """tanh-approximate GELU (reference gpt2/model.py:12-13)."""
    return F.gelu(x, approximate="tanh")


def _dense(x, w, b, policy: Policy):
    return x @ policy.cast_compute(w) + policy.cast_compute(b)


def _attend_cached(q, k, v, layer_cache, keep, drop):
    """Decode step (T == 1): attention over the read-only cache and the new
    token. keep/drop: [T_max] fp32 mask of the valid slots (< pos_offset)
    and NEG_BIG where it is 0."""
    scale = math.sqrt(q.shape[-1])
    T_max = layer_cache.shape[-2]
    q32 = q.float()
    lo = torch.matmul(q32, layer_cache[0].float().transpose(-1, -2)) / scale
    ln = (q32 * k.float()).sum(-1, keepdim=True) / scale
    w = torch.softmax(torch.cat([lo * keep + drop, ln], dim=-1), dim=-1).to(v.dtype)
    return torch.matmul(w[..., :T_max], layer_cache[1]) + w[..., T_max:] * v


def _attend(q, keys, vals, keep, drop):
    """Attention of q [B, H, T, hd] over keys/vals [B, H, K, hd] under the
    [T, K] mask keep (1 = visible) and drop = NEG_BIG * (1 - keep)."""
    logits = torch.matmul(q.float(), keys.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    w = torch.softmax(logits * keep + drop, dim=-1).to(vals.dtype)
    return torch.matmul(w, vals)


def _block_step(x, bp, layer_cache, pos_offset: int, cfg: GPT2Config, policy: Policy,
                keep, drop):
    """One transformer block over x: [B, T, D]. layer_cache: None, or the
    layer's [2, B, H, T_max, hd] cache; x's keys and values are written into
    it at positions [pos_offset, pos_offset + T)."""
    B, T, D = x.shape
    H = cfg.n_head
    hd = D // H
    h = _ln(x, bp["ln_1"], cfg.layer_norm_epsilon)
    qkv = _dense(h, bp["attn"]["c_attn_w"], bp["attn"]["c_attn_b"], policy)
    q, k, v = (t.reshape(B, T, H, hd).transpose(1, 2) for t in qkv.split(D, dim=-1))

    if layer_cache is None:
        a = _attend(q, k, v, keep, drop)
    elif T == 1:
        a = _attend_cached(q, k, v, layer_cache, keep, drop)
        layer_cache[0, :, :, pos_offset] = k[:, :, 0]
        layer_cache[1, :, :, pos_offset] = v[:, :, 0]
    else:
        layer_cache[0, :, :, pos_offset:pos_offset + T] = k
        layer_cache[1, :, :, pos_offset:pos_offset + T] = v
        a = _attend(q, layer_cache[0], layer_cache[1], keep, drop)
    a = a.transpose(1, 2).reshape(B, T, D)
    x = x + _dense(a, bp["attn"]["c_proj_w"], bp["attn"]["c_proj_b"], policy)

    h = _ln(x, bp["ln_2"], cfg.layer_norm_epsilon)
    h = _gelu(_dense(h, bp["mlp"]["c_fc_w"], bp["mlp"]["c_fc_b"], policy))
    return x + _dense(h, bp["mlp"]["c_proj_w"], bp["mlp"]["c_proj_b"], policy)


def _masks(T: int, pos_offset: int, T_max: Optional[int], device):
    """(keep, drop) of the reference's `w*b - 1e10*(1-b)` masking: without a
    cache the causal [T, T] mask; with one, a decode step's [T_max] mask of
    the valid slots, or the prefill's [T, T_max] causal mask over the cache."""
    if T_max is not None and T == 1:
        keep = (torch.arange(T_max, device=device) < pos_offset).float()
    else:
        key_pos = torch.arange(T if T_max is None else T_max, device=device)
        q_pos = pos_offset + torch.arange(T, device=device)
        keep = (key_pos[None, :] <= q_pos[:, None]).float()
    return keep, NEG_BIG * (1.0 - keep)


def forward(params, input_ids: torch.Tensor, cfg: GPT2Config = GPT2_124M,
            cache: Optional[List[torch.Tensor]] = None, pos_offset: int = 0,
            policy: Policy = FP32) -> Tuple[torch.Tensor, Optional[List[torch.Tensor]]]:
    """input_ids: [B, T] -> (logits [B, T, V] in the compute dtype, cache).

    cache: None, or a list of per-layer [2, B, H, T_max, hd] tensors, written
    in place at positions [pos_offset, pos_offset + T); attention then spans
    the whole cache under position masking. A step of T == 1 takes the
    decode path."""
    T = input_ids.shape[1]
    ids = input_ids.long()
    x = policy.cast_compute(params["wte"][ids])
    x = x + policy.cast_compute(params["wpe"][pos_offset:pos_offset + T])
    T_max = None if cache is None else cache[0].shape[-2]
    keep, drop = _masks(T, pos_offset, T_max, x.device)
    for layer, bp in enumerate(params["blocks"]):
        x = _block_step(x, bp, None if cache is None else cache[layer], pos_offset,
                        cfg, policy, keep, drop)
    x = _ln(x, params["ln_f"], cfg.layer_norm_epsilon)
    return x @ policy.cast_compute(params["wte"]).t(), cache


# ---------------------------------------------------------------- sampling

def _select_next(logits, temperature: float, top_k: int, sample: bool,
                 draws: Optional[torch.Tensor]):
    """Next-token rule of reference gpt2/sample.py:10-34: temperature scale,
    top-k floor to NEG_BIG, then a categorical draw (sample=True) or the
    argmax. The argmax is taken on the fp32 logits and elides the top-k mask,
    which only removes non-maximal logits; torch.argmax returns the first
    maximum, as jnp.argmax does.

    The draw inverts the kept tokens' CDF at `draws` [B], uniforms in [0, 1)
    made by the caller: token ids in ascending order, each weighing
    exp(logit - max). The kept tokens are the JAX package's: every logit
    below the k-th largest is floored, so all tokens that tie at the k-th
    value stay (more than k of them then). The pick is always a kept token,
    and a row's pick depends on its own logits and uniform alone."""
    if temperature <= 0:
        # the argmax elision (and the reference's division) presuppose a
        # positive temperature
        raise ValueError(f"temperature must be > 0, got {temperature}")
    logits = logits.float()
    if not sample:
        return logits.argmax(dim=-1)
    logits = logits / temperature
    keep = torch.ones_like(logits, dtype=torch.bool)
    if top_k:
        keep = logits >= torch.topk(logits, top_k, dim=-1).values[:, -1:]
    w = torch.where(keep, torch.exp(logits - logits.max(dim=-1, keepdim=True).values), 0.0)
    cdf = w.cumsum(dim=-1)
    target = draws.to(cdf)[:, None] * cdf[:, -1:]
    # the rank among the kept tokens of the first whose CDF passes the
    # target; counting kept tokens only keeps the pick on one of them
    rank = (keep & (cdf <= target)).sum(dim=-1, keepdim=True)
    rank = torch.minimum(rank, keep.sum(dim=-1, keepdim=True) - 1)
    return (keep & (keep.cumsum(dim=-1) == rank + 1)).byte().argmax(dim=-1)


def sample_sequence(params, context: torch.Tensor, length: int,
                    cfg: GPT2Config = GPT2_124M, temperature: float = 1.0,
                    top_k: int = 0, sample: bool = False,
                    draws: Optional[torch.Tensor] = None,
                    policy: Policy = FP32) -> torch.Tensor:
    """context: [B, T0] integer ids -> [B, T0 + length] (the context's dtype).

    Prefill fills the cache for the T0 context tokens and yields the first
    generated token; `length - 1` decode steps follow (reference
    gpt2/sample.py:21-36). sample=True reads `draws` [B, length], uniforms
    in [0, 1): column s picks the s-th generated token (`_select_next`), so
    a row's tokens depend on its own context and uniforms alone."""
    B, T0 = context.shape
    if sample:
        if draws is None or tuple(draws.shape) != (B, length):
            raise ValueError(f"a sampled decode of {B} rows x {length} tokens needs draws of "
                             f"that shape, got {None if draws is None else tuple(draws.shape)}")
        draws = draws.to(context.device)
    H, hd = cfg.n_head, cfg.n_embd // cfg.n_head
    cache = [torch.zeros((2, B, H, T0 + length, hd), dtype=policy.compute_dtype,
                         device=context.device) for _ in range(cfg.n_layer)]
    # the matmul weights in the compute dtype once, before the loop (a no-op
    # for weights staged that way); the LayerNorm parameters stay raw
    params = precast_params(params, policy, PRECAST_EXCLUDE)

    logits, _ = forward(params, context, cfg, cache, 0, policy)

    def pick(logits, s):
        return _select_next(logits[:, -1], temperature, top_k, sample,
                            draws[:, s] if sample else None)

    tok = pick(logits, 0)
    toks = [tok]
    for pos in range(T0, T0 + length - 1):
        logits, _ = forward(params, tok[:, None], cfg, cache, pos, policy)
        tok = pick(logits, pos - T0 + 1)
        toks.append(tok)
    return torch.cat([context, torch.stack(toks, dim=1).to(context.dtype)], dim=1)
