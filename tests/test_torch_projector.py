"""The port's projector (clip_glass_torch.projector) against the JAX
package's on the CPU, fp32, TINY StyleGAN2 G: the same weights, the same
dlatent-statistics draw, noise planes and per-step jitter draws (the JAX
keys' numbers, fed to the port's functions).

Tolerances, relative to each tensor's scale (`assert_close_scaled`): 1e-5
for the dlatent statistics, Adam against optax, and the projector's state
(dlatents, noise planes, the noise planes' Adam moments) and its two
distances after each of three steps. The dlatents' Adam moments hold the
raw gradient of the distance through G (LPIPS at div 8 on a 16 px image),
a sum with much cancellation: the JAX package's own jitted and eager
gradients differ by 1.4e-4 of its scale (4.2e-6 with the L2 distance), and
the port's by 4e-5 from the jitted one; those moments are held at 1e-4 (the
second moment, a square, at 2e-4). Adam's update divides the first moment
by the root of the second, so the state after a step agrees at 1e-7.

The step's learning rate is 0 at t = 0 and 0.1 at t = 0.05 and 0.1
(num_steps = 20): the second and third steps move the dlatents by up to 0.1
each.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

import torch

from clip_glass_tpu.models.stylegan2 import model as jsg2
from clip_glass_tpu.projector import Projector as JProjector
from clip_glass_tpu.projector import ProjectorConfig as JConfig

from clip_glass_torch import projector as tproj
from clip_glass_torch.models.stylegan2 import model as tsg2
from clip_glass_torch.weights import from_jax

from test_torch_autograd import card_branch  # noqa: F401 (a fixture)
from test_torch_metrics import lpips_tree
from torch_parity import N, T, assert_close_scaled

NUM_STEPS = 20


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    """The TINY G as both packages hold it (noise strengths drawn nonzero, so
    the image depends on the noise planes), LPIPS at div 8, and a target:
    the G sample of another latent, in [0, 1]."""
    tree = tsg2.generator_tree(torch.Generator().manual_seed(4), tsg2.TINY)
    rng = np.random.default_rng(5)
    for bp in tree["synthesis"]["blocks"]:
        for lp in bp["layers"]:
            lp["noise_scale"] = torch.tensor(rng.uniform(0.1, 0.3), dtype=torch.float32)
    np_tree = jax.tree.map(lambda t: t.numpy(), tree)
    z = rng.normal(size=(1, tsg2.TINY.latent_size)).astype(np.float32)
    img = jsg2.generator_apply(_jax(np_tree), jnp.asarray(z), jsg2.TINY, noise="none")
    target = np.asarray(jnp.clip((img + 1.0) / 2.0, 0.0, 1.0))
    return _jax(np_tree), from_jax.convert_generator(np_tree), lpips_tree(6), target


def _projectors(tiny, distance: str):
    jg, tg, ltree, _ = tiny
    cfg = dict(num_steps=NUM_STEPS, dlatent_samples=256)
    lp = ltree if distance == "lpips" else None
    jp = JProjector(jg, jsg2.TINY, cfg=JConfig(**cfg),
                    lpips_params=None if lp is None else _jax(lp))
    tp = tproj.Projector(tg, tsg2.TINY, cfg=tproj.ProjectorConfig(**cfg),
                         lpips_params=None if lp is None else from_jax.convert_lpips(lp),
                         device="cpu")
    # the statistics from the JAX draw
    z = jax.random.normal(jax.random.PRNGKey(0), (256, tsg2.TINY.latent_size))
    tp.dlatent_avg, tp.dlatent_std = tproj.dlatent_statistics(tg["mapping"], T(z), tsg2.TINY)
    return jp, tp


def test_dlatent_statistics_match_jax(tiny):
    jp, tp = _projectors(tiny, "l2")
    assert_close_scaled(N(tp.dlatent_avg), np.asarray(jp.dlatent_avg), 1e-5)
    assert_close_scaled(N(tp.dlatent_std), np.asarray(jp.dlatent_std), 1e-5)
    # the spread over all elements divided by N only, not torch.std
    z = torch.randn((64, 32), generator=torch.Generator().manual_seed(1))
    w = tsg2.mapping_apply(tiny[1]["mapping"], z, tsg2.TINY)
    _, std = tproj.dlatent_statistics(tiny[1]["mapping"], z, tsg2.TINY)
    assert std.ndim == 0
    assert torch.isclose(std, ((w - w.mean(0)) ** 2).sum().div(64).sqrt())
    assert not torch.isclose(std, w.std())


@pytest.mark.parametrize("t", [0.0, 0.01, 0.05, 0.3, 0.74, 0.8, 0.95])
def test_schedules_match_jax(tiny, t):
    jp, tp = _projectors(tiny, "l2")
    assert float(tp.lr_schedule(t)) == pytest.approx(float(jp._lr_schedule(jnp.float32(t))),
                                                     rel=1e-6, abs=1e-9)
    assert float(tp.noise_strength(t)) == pytest.approx(
        float(jp._noise_strength(jnp.float32(t))), rel=1e-6, abs=1e-9)


def test_adam_matches_optax():
    """Three updates of optax.adam(1.0) against adam_update on the same
    gradients: updates and both moments."""
    rng = np.random.default_rng(7)
    params = [rng.normal(size=(2, 5, 8)).astype(np.float32), rng.normal(size=(8, 8)).astype(np.float32)]
    opt = optax.adam(1.0, b1=0.9, b2=0.999)
    jstate = opt.init([jnp.asarray(p) for p in params])
    tstate = tproj.adam_init([T(p) for p in params])
    for step in range(3):
        grads = [rng.normal(size=p.shape).astype(np.float32) * 10.0 ** (step - 2) for p in params]
        ju, jstate = opt.update([jnp.asarray(g) for g in grads], jstate)
        tu, tstate = tproj.adam_update([T(g) for g in grads], tstate)
        assert tstate.count == int(jstate[0].count) == step + 1
        for got, want in zip(tu + tstate.mu + tstate.nu,
                             list(ju) + list(jstate[0].mu) + list(jstate[0].nu)):
            assert_close_scaled(N(got), np.asarray(want), 1e-6)


def test_noise_renormalization_is_population_std():
    n = torch.randn(16, 16, generator=torch.Generator().manual_seed(8)) * 3 + 1
    r = tproj.renormalize(n)
    np.testing.assert_allclose(N(r), (N(n) - N(n).mean()) / N(n).std(), rtol=1e-5, atol=1e-6)
    assert abs(float(r.std(correction=0)) - 1.0) < 1e-5


@pytest.mark.parametrize("distance", ["lpips", "l2"])
def test_three_steps_match_jax(tiny, distance):
    """Three steps from the same start: after each, the dlatents, the noise
    planes, Adam's moments, the loss and the distance."""
    jp, tp = _projectors(tiny, distance)
    target = tiny[3]
    mc = jsg2.TINY
    key = jax.random.PRNGKey(jp.cfg.seed + 1)
    dlatents = jnp.broadcast_to(jp.dlatent_avg[None, None, :], (1, mc.num_latents, mc.latent_size))
    k_noise, key = jax.random.split(key)
    noises = [jax.random.normal(k, s) for k, s in zip(
        jax.random.split(k_noise, len(mc.noise_shapes())), mc.noise_shapes())]
    jvars = (dlatents, noises)
    jstate = jp._optim.init(jvars)
    tvars = (tp.dlatent_avg[None, None, :].expand(1, mc.num_latents, mc.latent_size).clone(),
             [T(n) for n in noises])
    tstate = tproj.adam_init([tvars[0], *tvars[1]])
    for i in range(3):
        key, sub = jax.random.split(key)
        t = i / NUM_STEPS
        jvars, jstate, jloss, jdist = jp._step_fn(jvars, jstate, jnp.asarray(target), sub,
                                                   jnp.float32(t))
        draw = T(jax.random.normal(sub, dlatents.shape))
        tvars, tstate, tloss, tdist = tp.step(tvars, tstate, T(target), draw, t)
        assert_close_scaled(N(tvars[0]), np.asarray(jvars[0]), 1e-5)
        for got, want in zip(tvars[1], jvars[1]):
            assert_close_scaled(N(got), np.asarray(want), 1e-5)
        adam = jstate[0]
        assert_close_scaled(N(tstate.mu[0]), np.asarray(adam.mu[0]), 1e-4)
        assert_close_scaled(N(tstate.nu[0]), np.asarray(adam.nu[0]), 2e-4)
        for got, want in zip(tstate.mu[1:] + tstate.nu[1:], [*adam.mu[1], *adam.nu[1]]):
            assert_close_scaled(N(got), np.asarray(want), 1e-5)
        assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
        assert float(tdist) == pytest.approx(float(jdist), rel=1e-5)
    assert not np.allclose(N(tvars[0]), np.asarray(dlatents))   # the steps moved


@pytest.mark.parametrize("distance", ["lpips", "l2"])
def test_project_reduces_the_distance(tiny, distance):
    _, tg, ltree, target = tiny
    lp = from_jax.convert_lpips(ltree) if distance == "lpips" else None
    proj = tproj.Projector(tg, tsg2.TINY, cfg=tproj.ProjectorConfig(
        num_steps=20, dlatent_samples=256), lpips_params=lp, device="cpu")
    target = T(target)
    mc = tsg2.TINY
    start = proj.dlatent_avg[None, None, :].expand(1, mc.num_latents, mc.latent_size)
    with torch.inference_mode():
        d0 = float(proj.distance(proj.synthesize(start, [torch.zeros(s) for s in
                                                         mc.noise_shapes()]), target).sum())
    dlatents, images = proj.project(target)
    assert dlatents.shape == (1, mc.num_latents, mc.latent_size)
    assert images.shape == target.shape and (images >= 0).all() and (images <= 1).all()
    with torch.inference_mode():
        d1 = float(proj.distance(images, target).sum())
    assert np.isfinite(d0) and d1 < d0


STEP_SEED = 0


def test_step_takes_inference_tensors_and_refuses_inference_mode(tiny):
    """The statistics, a target or a start made under inference_mode still
    give a gradient; the step itself under inference_mode raises (autograd
    records nothing there). The start's noise planes and the jitter come
    from the test's own generator (seed STEP_SEED), whatever ran before."""
    _, tg, _, target = tiny
    proj = tproj.Projector(tg, tsg2.TINY, cfg=tproj.ProjectorConfig(
        num_steps=4, dlatent_samples=64), device="cpu")
    mc = tsg2.TINY
    g = torch.Generator().manual_seed(STEP_SEED)
    with torch.inference_mode():
        start = (proj.dlatent_avg[None, None, :].expand(1, mc.num_latents, mc.latent_size)
                 .clone(), [torch.randn(s, generator=g) for s in mc.noise_shapes()])
        draw = torch.randn(start[0].shape, generator=g)
        tgt = T(target) * 1.0
        image = proj.synthesize(start[0] + proj.noise_strength(0.5) * draw, start[1])
    # a saturated image (ROADMAP item 19) has no gradient through the clamp
    assert ((image > 0) & (image < 1)).any(), (
        f"precondition: seed {STEP_SEED}'s start saturates the TINY image, so the step "
        "gets no gradient")
    state = tproj.adam_init([start[0], *start[1]])
    (dl, _), state, _, _ = proj.step(start, state, tgt, draw, 0.5)
    assert state.count == 1 and not torch.equal(dl, start[0])
    with torch.inference_mode(), pytest.raises(RuntimeError, match="inference_mode"):
        proj.step(start, state, tgt, draw, 0.5)


def test_projector_step_synthesizes_in_the_plain_domain(tiny, monkeypatch):
    """With s2d levels in the model config (TINY with s2d_min_res=8), the
    differentiated synthesis still runs plain: no s2d conv under grad."""
    from clip_glass_torch.ops import s2d

    _, tg, _, target = tiny
    cfg = dataclasses.replace(tsg2.TINY, s2d_min_res=8)
    proj = tproj.Projector(tg, cfg, cfg=tproj.ProjectorConfig(num_steps=2, dlatent_samples=64),
                           device="cpu")
    calls = []
    monkeypatch.setattr(s2d, "s2d_conv2x2", lambda *a, **k: calls.append(1))
    mc = cfg
    start = (proj.dlatent_avg[None, None, :].expand(1, mc.num_latents, mc.latent_size).clone(),
             [torch.randn(s) for s in mc.noise_shapes()])
    proj.step(start, tproj.adam_init([start[0], *start[1]]), T(target),
              torch.randn(start[0].shape), 0.5)
    assert calls == [] and proj.plain_cfg.s2d_min_res == 2 ** 30


def test_step_through_the_kernels_grad_function_equals_the_plain_route(tiny, card_branch):
    """The card's route on the CPU: the wrappers take their CUDA branch (each
    launch its plain version, tests/test_torch_autograd.py's `card_branch`),
    so kernels 1-3 record the step's gradient through `cuda._KernelGrad` (5
    epilogues, 2 skip upsamples, 3 ToRGB on TINY; kernel 4 none), and the
    step's state equals the plain route's: bitwise but for the dlatents and
    their moments, whose gradient autograd sums from its per-layer parts in
    another order through the Function (within 1e-6 of their scale; 3.2e-7
    seen)."""
    from clip_glass_torch.ops import cuda

    _, tg, ltree, target = tiny
    mc = tsg2.TINY
    gen = torch.Generator().manual_seed(9)
    start = (torch.randn((1, mc.num_latents, mc.latent_size), generator=gen) * 0.3,
             [torch.randn(s, generator=gen) for s in mc.noise_shapes()])
    draw = torch.randn(start[0].shape, generator=gen)
    results = {}
    for route in ("kernels", "plain"):
        proj = tproj.Projector(tg, mc, cfg=tproj.ProjectorConfig(num_steps=4, dlatent_samples=64),
                               lpips_params=from_jax.convert_lpips(ltree), device="cpu")
        state = tproj.adam_init([start[0], *start[1]])
        before = dict(cuda.with_grad.recorded)
        if route == "plain":
            cuda.takes_plain, saved = (lambda t: True), cuda.takes_plain
        try:
            vars_, state, loss, dist = proj.step(start, state, T(target), draw, 0.5)
        finally:
            if route == "plain":
                cuda.takes_plain = saved
        moved = {k: v - before.get(k, 0) for k, v in cuda.with_grad.recorded.items()
                 if v != before.get(k, 0)}
        results[route] = (vars_, state, loss, dist, moved)
    assert results["kernels"][4] == {"noise_bias_lrelu": 5, "upsample2x": 2,
                                     "modulated_matmul": 3}
    assert results["plain"][4] == {}
    (kv, ks, kl, kd, _), (pv, ps, pl, pd, _) = results["kernels"], results["plain"]
    for a, b in zip([*kv[1], *ks.mu[1:], *ks.nu[1:], kl, kd],
                    [*pv[1], *ps.mu[1:], *ps.nu[1:], pl, pd]):
        assert torch.equal(a, b)
    for a, b in ((kv[0], pv[0]), (ks.mu[0], ps.mu[0]), (ks.nu[0], ps.nu[0])):
        assert_close_scaled(N(a), N(b), 1e-6)


def test_example_projects_tiny_with_a_converted_lpips(tmp_path):
    """examples/project_image_torch.py on the CPU: TINY, 5 steps, the
    distance LPIPS from the npz that the convert CLI's lpips kind wrote (read
    by the port's metrics.lpips.load_npz, not by restore_lists, which breaks
    the JAX example's --lpips); both artifacts written."""
    import os
    import subprocess
    import sys

    from clip_glass_torch.weights import convert_weights, synthesize

    vgg, lin, npz = (str(tmp_path / n) for n in ("vgg16.pth", "vgg.pth", "lpips.npz"))
    synthesize.write_vgg16(vgg, div=8)
    synthesize.write_lpips_linear(lin, div=8)
    assert convert_weights.main(["lpips", vgg, npz, "--linear", lin]) == 0
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path / "out"
    r = subprocess.run([sys.executable, os.path.join(repo, "examples", "project_image_torch.py"),
                        "--device", "cpu", "--steps", "5", "--lpips", npz, "--out", str(out)],
                       capture_output=True, text=True, cwd=str(tmp_path), timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "project step 5/5" in r.stdout and "distance(target, target) = 0.00000" in r.stdout
    assert (out / "target_vs_projected.jpg").exists()
    with np.load(out / "dlatents.npz") as d:
        assert d["dlatents"].shape == (1, tsg2.TINY.num_latents, tsg2.TINY.latent_size)
