"""clip_glass_torch's GPT-2 (models/gpt2/model.py) against the JAX package's
on the TINY config, with the JAX weights carried across by
weights.from_jax.convert_gpt2 (biases and LayerNorm parameters perturbed,
so every term counts).

Tolerances: fp32 logits 1e-5 (summation order only; the logits are ~4);
bf16 logits two bf16 ulps at the logits' scale (the two packages round the
bf16 matmul outputs and adds at the same points, but their CPU kernels
accumulate in different orders). The argmax decode is token-exact in fp32."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch

from clip_glass_tpu.core.dtypes import FP32 as JFP32
from clip_glass_tpu.core.dtypes import Policy as JPolicy
from clip_glass_tpu.fitness import latent as jlatent
from clip_glass_tpu.models.gpt2 import model as jg2

from clip_glass_torch.core.dtypes import BF16, FP32, precast_params
from clip_glass_torch.fitness import latent as tlatent
from clip_glass_torch.models.gpt2 import model as tg2
from clip_glass_torch.weights import from_jax

CFG = jg2.TINY
JBF16 = JPolicy.make("float32", "bfloat16")
POLICIES = {"fp32": (JFP32, FP32), "bf16": (JBF16, BF16)}


@pytest.fixture(scope="module")
def params():
    jp = jg2.init(jax.random.PRNGKey(0), CFG)
    rng = np.random.default_rng(0)

    def perturb(path, leaf):
        name = jax.tree_util.keystr(path)
        if name.endswith("['g']") or name.endswith("['b']") or name.endswith("_b']"):
            return leaf + 0.1 * rng.normal(size=leaf.shape).astype(np.float32)
        return leaf

    jp = jax.tree_util.tree_map_with_path(perturb, jp)
    return jp, from_jax.convert_gpt2(jax.tree.map(np.asarray, jp))


def _ids(seed, B, T):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, (B, T)).astype(np.int32)


def _assert_logits_close(got, want, name):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    if name == "fp32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * ulp)


def test_layer_norm_and_gelu_match_jax():
    """F.layer_norm on the fp32 cast and F.gelu(tanh) against the JAX
    package's explicit `_ln` and `_gelu` (fp32)."""
    rng = np.random.default_rng(1)
    x = (3 * rng.normal(size=(5, 7, 64)) + 1).astype(np.float32)
    p = {"g": rng.normal(size=64).astype(np.float32), "b": rng.normal(size=64).astype(np.float32)}
    want = np.asarray(jg2._ln(jnp.asarray(x), jax.tree.map(jnp.asarray, p), 1e-5))
    got = tg2._ln(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()}, 1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tg2._gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jg2._gelu(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_forward_logits_match_jax(params, name):
    jp, tp = params
    ids = _ids(2, 3, 9)
    want, _ = jg2.forward(jp, jnp.asarray(ids), CFG, policy=POLICIES[name][0])
    got, cache = tg2.forward(tp, torch.from_numpy(ids), CFG, policy=POLICIES[name][1])
    assert cache is None
    _assert_logits_close(got, want, name)


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_prefill_and_decode_with_cache_match_jax(params, name):
    """Prefill of 6 tokens into a T_max = 9 cache, then two decode steps;
    the logits and the caches against the JAX package's per-layer cache
    path (the one sample_sequence takes)."""
    jp, tp = params
    jpol, tpol = POLICIES[name]
    ids = _ids(3, 4, 8)
    shape = (2, 4, CFG.n_head, 9, CFG.n_embd // CFG.n_head)
    jc = tuple(jnp.zeros(shape, jpol.compute_dtype) for _ in range(CFG.n_layer))
    tc = [torch.zeros(shape, dtype=tpol.compute_dtype) for _ in range(CFG.n_layer)]
    for pos, T in ((0, 6), (6, 1), (7, 1)):
        want, jc = jg2.forward(jp, jnp.asarray(ids[:, pos:pos + T]), CFG, jc, pos, jpol)
        got, tc = tg2.forward(tp, torch.from_numpy(ids[:, pos:pos + T]), CFG, tc, pos, tpol)
        _assert_logits_close(got, want, name)
    for j, t in zip(jc, tc):
        _assert_logits_close(t, j, name)


def test_cached_decode_equals_full_forward(params):
    """Prefill + one-token steps through the cache give the logits of one
    forward over the whole sequence, position by position (fp32)."""
    _, tp = params
    ids = torch.from_numpy(_ids(4, 2, 10))
    full, _ = tg2.forward(tp, ids, CFG)
    cache = [torch.zeros((2, 2, CFG.n_head, 10, CFG.n_embd // CFG.n_head))
             for _ in range(CFG.n_layer)]
    steps = [tg2.forward(tp, ids[:, :4], CFG, cache, 0)[0]]
    steps += [tg2.forward(tp, ids[:, p:p + 1], CFG, cache, p)[0] for p in range(4, 10)]
    torch.testing.assert_close(torch.cat(steps, dim=1), full, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,T0,length", [(4, 7, 6), (3, 2, 9)])
def test_sample_sequence_argmax_is_token_exact(params, B, T0, length):
    jp, tp = params
    ctx = _ids(5 + T0, B, T0)
    want = np.asarray(jg2.sample_sequence(jp, jnp.asarray(ctx), length, CFG))
    got = tg2.sample_sequence(tp, torch.from_numpy(ctx), length, CFG)
    assert got.dtype == torch.int32 and got.shape == (B, T0 + length)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sample_sequence_bf16_weights_staged_once(params):
    """The bf16 decode casts the matmul weights once; weights staged in bf16
    beforehand (the Generator's staging) give the same ids, and the LN
    parameters stay fp32."""
    _, tp = params
    ctx = torch.from_numpy(_ids(6, 4, 5))
    staged = precast_params(tp, BF16, tg2.PRECAST_EXCLUDE)
    assert staged["blocks"][0]["ln_1"]["g"].dtype == torch.float32
    assert staged["blocks"][0]["mlp"]["c_fc_w"].dtype == torch.bfloat16
    a = tg2.sample_sequence(tp, ctx, 5, CFG, policy=BF16)
    b = tg2.sample_sequence(staged, ctx, 5, CFG, policy=BF16)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_sampling_branch_draws_valid_ids_within_top_k(params):
    """sample=True: seeded draws, valid ids, each drawn token among the top
    k of its step's (temperature-scaled) logits; temperature <= 0 raises."""
    _, tp = params
    ctx = torch.from_numpy(_ids(7, 6, 4))

    def draws():
        return torch.rand((6, 5), generator=torch.Generator().manual_seed(0))

    out = tg2.sample_sequence(tp, ctx, 5, CFG, temperature=0.7, top_k=3, sample=True,
                              draws=draws())
    again = tg2.sample_sequence(tp, ctx, 5, CFG, temperature=0.7, top_k=3, sample=True,
                                draws=draws())
    torch.testing.assert_close(out, again, rtol=0, atol=0)
    assert ((0 <= out) & (out < CFG.vocab_size)).all()
    logits, _ = tg2.forward(tp, out[:, :-1], CFG)
    top = torch.topk(logits[:, 3:].float(), 3, dim=-1).indices
    assert (top == out[:, 4:, None].long()).any(-1).all()
    with pytest.raises(ValueError, match="temperature"):
        tg2._select_next(logits[:, -1], 0.0, 0, False, None)


def test_argmax_takes_the_first_of_tied_maxima():
    """A planted tie at the largest bf16 logit: the port's rule picks the
    first index, as jnp.argmax (JAX's rule) does."""
    logits = np.random.default_rng(8).normal(size=(3, 50257)).astype(np.float32)
    logits[0, [17, 4000, 50000]] = 9.0
    logits[1, [50255, 3]] = 9.0
    logits[2, 123] = 9.0
    lb = torch.from_numpy(logits).to(torch.bfloat16)
    want = np.asarray(jnp.argmax(jnp.asarray(lb.float().numpy()), axis=-1))
    got = tg2._select_next(lb, 1.0, 40, False, None)
    assert got.tolist() == want.tolist() == [17, 3, 123]


def test_fully_masked_row_is_uniform_not_nan():
    """The multiplicative NEG_BIG mask: a row with every key masked
    softmaxes to a uniform row (the reference's semantics), where -inf
    would give NaN."""
    q = torch.randn(1, 1, 2, 4)
    kv = torch.randn(1, 1, 3, 4)
    keep = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    out = tg2._attend(q, kv, kv, keep, tg2.NEG_BIG * (1.0 - keep))
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out[0, 0, 0], kv[0, 0].mean(0))
    torch.testing.assert_close(out[0, 0, 1], kv[0, 0, 0])


def test_init_tree_converts_to_the_port_layout():
    """The port's seeded init in the JAX layout (stacked blocks) and after
    convert_gpt2: the same tensors, one dict per layer, [in, out] weights."""
    tree = tg2.init_tree(torch.Generator().manual_seed(0), CFG)
    p = tg2.init(torch.Generator().manual_seed(0), CFG)
    D = CFG.n_embd
    assert tree["blocks"]["attn"]["c_attn_w"].shape == (CFG.n_layer, D, 3 * D)
    assert len(p["blocks"]) == CFG.n_layer and p["wte"].shape == (CFG.vocab_size, D)
    for layer in range(CFG.n_layer):
        torch.testing.assert_close(p["blocks"][layer]["mlp"]["c_fc_w"],
                                   tree["blocks"]["mlp"]["c_fc_w"][layer], rtol=0, atol=0)
    assert abs(p["wte"].std().item() - 0.02) < 1e-3


def test_decode_gpt2_rounds_half_to_even_as_jax():
    x = np.array([[0.5, 1.5, 2.5, 50255.5, 3.49, 7.0, 50256.0]], np.float32)
    (got,) = tlatent.decode_gpt2(torch.from_numpy(x))
    (want,) = jlatent.decode_gpt2(jnp.asarray(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [[0, 2, 2, 50256, 3, 7, 50256]]
