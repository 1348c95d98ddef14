"""Converted checkpoints and the search state on disk.

- The npz tree format: the port's core/pytree against the JAX package's, in
  both directions, bitwise.
- Converted checkpoints: a JAX TINY problem's G, D, noise planes and CLIP,
  written with the JAX package's own `save_npz` and `_cfg.json` sidecars.
  Both packages' Generators load the directory, and their eval_population
  agrees at 1e-4 of each objective's scale (fp32 on both sides, as
  tests/test_torch_fitness.py); the port loads the same weights bitwise.
- `ga_state.npz`: saving and loading restores the population and the
  generator's stream exactly; `load_state` refuses a file the JAX package
  wrote and a file from the other device's generator.
"""

import dataclasses
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch

from clip_glass_tpu.config import get_config as jget_config
from clip_glass_tpu.core import checkpoint as jcheckpoint
from clip_glass_tpu.core import pytree as jpytree
from clip_glass_tpu.evolve.algorithm import GAState as JState
from clip_glass_tpu.fitness.problem import GenerationProblem as JProblem
from clip_glass_tpu.models.clip import model as jclip
from clip_glass_tpu.models.stylegan2 import model as jsg2

from clip_glass_torch.config import get_config
from clip_glass_torch.core import checkpoint, pytree
from clip_glass_torch.evolve.algorithm import GAState
from clip_glass_torch.fitness.generator import Generator
from clip_glass_torch.fitness.problem import GenerationProblem
from clip_glass_torch.models.clip import model as tclip
from clip_glass_torch.models.stylegan2 import model as tsg2

from torch_parity import N, T, assert_close_scaled

POP = 8


def _config(get, weights="random:0"):
    return get("StyleGAN2_ffhq_d").replace(
        pop_size=POP, batch_size=4, dim_z=32, n_var=32, weights=weights,
        target="a red flower", compute_dtype="float32")


def _perturbed(tree, rng):
    """Random biases and noise scales (the random init leaves them zero),
    so that loading them counts."""
    def f(path, leaf):
        names = [str(getattr(p, "key", "")) for p in path]
        if names[-1] in ("b", "noise_scale") and "style" not in names:
            return np.asarray(rng.normal(size=np.shape(leaf)).astype(np.float32) * 0.3)
        return np.asarray(leaf)
    return jax.tree_util.tree_map_with_path(f, tree)


def _write_cfg(path, cfg):
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(cfg), f)


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """A directory in the converted layout, written by the JAX package."""
    root = tmp_path_factory.mktemp("weights")
    jprob = JProblem(_config(jget_config), clip_cfg=jclip.TINY, model_cfg=jsg2.TINY)
    gen = jprob.generator
    rng = np.random.default_rng(3)
    trees = {"Gs": _perturbed(gen.g_params, rng), "D": _perturbed(gen.d_params, rng),
             "clip": jax.tree.map(np.asarray, gen.clip_params)}
    for stem, tree in trees.items():
        jpytree.save_npz(str(root / f"{stem}.npz"), tree)
    noise = [np.asarray(nz) for nz in gen.noise]
    assert [nz.ndim for nz in noise] == [2] * len(noise)  # TINY: plain planes
    jpytree.save_npz(str(root / "Gs_noise.npz"), {str(i): nz for i, nz in enumerate(noise)})
    _write_cfg(root / "Gs_cfg.json", jsg2.TINY)
    _write_cfg(root / "D_cfg.json", jsg2.TINY)
    _write_cfg(root / "clip_cfg.json", jclip.TINY)
    return root, trees, noise


def _X(seed=0):
    return np.random.default_rng(seed).normal(size=(POP, 32)).astype(np.float32)


def test_pytree_npz_matches_jax_both_ways(tmp_path, rng):
    tree = {"a": {"w": rng.normal(size=(3, 4)).astype(np.float32),
                  "i": np.arange(5, dtype=np.int32)},
            "blocks": [{"b": rng.normal(size=(2,)).astype(np.float32)}
                       for _ in range(12)]}
    pytree.save_npz(str(tmp_path / "t.npz"), tree)
    jpytree.save_npz(str(tmp_path / "j.npz"), tree)
    for got in (pytree.restore_lists(pytree.load_npz(str(tmp_path / "j.npz"))),
                jax.tree.map(np.asarray, jpytree.restore_lists(
                    jpytree.load_npz(str(tmp_path / "t.npz"))))):
        assert jax.tree.structure(got) == jax.tree.structure(tree)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert pytree.flatten(tree).keys() == jpytree.flatten(tree).keys()
    assert isinstance(pytree.load_npz(str(tmp_path / "t.npz"))["a"]["w"], np.ndarray)


def test_converted_checkpoint_fitness_matches_jax(converted):
    """Both packages load the same directory; eval_population agrees."""
    root, _, _ = converted
    jprob = JProblem(_config(jget_config, weights=str(root)),
                     clip_weights=str(root / "clip.npz"))
    tprob = GenerationProblem(_config(get_config, weights=str(root)), device="cpu",
                              clip_weights=str(root / "clip.npz"))
    assert tprob.generator.model_cfg == tsg2.TINY and tprob.generator.clip_cfg == tclip.TINY
    X = _X()
    want = np.asarray(jax.jit(jprob.generator.eval_population)(
        jnp.asarray(X), jprob.generator.bundle))
    got = N(tprob.generator.eval_population(T(X)))
    assert got.shape == (POP, 2) and np.isfinite(got).all()
    for j in range(2):
        assert_close_scaled(got[:, j], want[:, j], 1e-4)


def test_converted_checkpoint_loads_the_written_weights(converted):
    """The port's staged parameters are the written ones, bitwise (fp32)."""
    from clip_glass_torch.weights import from_jax

    root, trees, noise = converted
    gen = Generator(_config(get_config, weights=str(root)), device="cpu",
                    clip_weights=str(root / "clip.npz"))
    want = {"g": from_jax.convert_generator(trees["Gs"]),
            "d": from_jax.convert_discriminator(trees["D"]),
            "clip": from_jax.convert_clip(trees["clip"])}
    for name, got in (("g", gen.g_params), ("d", gen.d_params), ("clip", gen.clip_params)):
        flat_w, flat_g = pytree.flatten(want[name]), pytree.flatten(got)
        assert flat_w.keys() == flat_g.keys(), name
        for k in flat_w:
            assert torch.equal(flat_g[k], flat_w[k]), f"{name}.{k}"
    for got, w in zip(gen.noise, noise):
        np.testing.assert_array_equal(N(got), w)


def test_checkpoint_reads_g_npz_and_draws_missing_noise(converted, tmp_path):
    """G.npz without Gs.npz loads too; without <stem>_noise.npz the noise is
    drawn from NOISE_SEED, as for random weights."""
    import shutil

    root, _, noise = converted
    for src, dst in (("Gs.npz", "G.npz"), ("Gs_cfg.json", "G_cfg.json"), ("D.npz", "D.npz")):
        shutil.copy(root / src, tmp_path / dst)
    gen = Generator(_config(get_config, weights=str(tmp_path)), device="cpu",
                    clip_weights=str(root / "clip.npz"))
    rand = Generator(_config(get_config), device="cpu", clip_cfg=tclip.TINY,
                     model_cfg=tsg2.TINY)
    for a, b in zip(gen.noise, rand.noise):
        assert torch.equal(a, b)
    assert not np.array_equal(N(gen.noise[0]), noise[0])


def test_unloadable_weights_raise(converted, tmp_path):
    """A missing directory or file: FileNotFoundError, as the JAX package.
    The reference's own formats load: a directory holding `Gs.pth` and
    `D.pth` (preferred over the npz stems beside them) and an OpenAI CLIP
    `.pt`."""
    from clip_glass_torch.weights import synthesize

    root, _, _ = converted
    with pytest.raises(FileNotFoundError):
        Generator(_config(get_config, weights=str(tmp_path / "none")), device="cpu",
                  clip_cfg=tclip.TINY, model_cfg=tsg2.TINY)
    synthesize.write_stylegan2_pth(str(tmp_path), tsg2.TINY, seed=1)
    for name in ("Gs.npz", "Gs_cfg.json", "D.npz"):
        (tmp_path / name).write_bytes((root / name).read_bytes())
    gen = Generator(_config(get_config, weights=str(tmp_path)), device="cpu",
                    clip_cfg=tclip.TINY, model_cfg=tsg2.TINY)
    assert gen.model_cfg == dataclasses.replace(tsg2.TINY, mbstd_group_size=4)
    from clip_glass_torch.weights import convert_stylegan2, from_jax

    want = from_jax.convert_generator(convert_stylegan2.load_pth(str(tmp_path / "Gs.pth"))[0])
    got, want = pytree.flatten(gen.g_params), pytree.flatten(want)
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in got)
    synthesize.write_clip(str(tmp_path / "ViT-B-32.pt"), tclip.TINY, seed=2)
    gen = Generator(_config(get_config), device="cpu", model_cfg=tsg2.TINY,
                    clip_weights=str(tmp_path / "ViT-B-32.pt"))
    assert gen.clip_cfg == dataclasses.replace(tclip.TINY, transformer_heads=1)
    with pytest.raises(FileNotFoundError):
        Generator(_config(get_config), device="cpu", model_cfg=tsg2.TINY,
                  clip_weights=str(tmp_path / "clip.npz"))
    with pytest.raises(FileNotFoundError):
        Generator(_config(get_config), device="cpu", model_cfg=tsg2.TINY,
                  clip_weights=str(tmp_path / "RN50.pt"))


def _state(rng, gen=3):
    return GAState(X=T(rng.normal(size=(POP, 32))), F=T(rng.normal(size=(POP, 2))),
                   gen=gen)


def test_state_round_trip_continues_the_stream(tmp_path, rng):
    g = torch.Generator().manual_seed(5)
    torch.rand(7, generator=g)
    state = _state(rng)
    checkpoint.save_state(state, g, str(tmp_path), "StyleGAN2_ffhq_d")
    want = torch.rand(11, generator=g)
    h = torch.Generator().manual_seed(99)
    got = checkpoint.load_state(str(tmp_path), h)
    assert torch.equal(torch.rand(11, generator=h), want)
    assert torch.equal(got.X, state.X) and torch.equal(got.F, state.F) and got.gen == 3
    assert checkpoint.checkpoint_config_name(str(tmp_path)) == "StyleGAN2_ffhq_d"
    assert checkpoint.load_state(str(tmp_path / "none"), h) is None
    assert not list(tmp_path.glob("*.tmp"))


def test_load_state_refuses_a_jax_file(tmp_path, rng):
    js = JState(X=jnp.asarray(rng.normal(size=(POP, 32)), jnp.float32),
                F=jnp.zeros((POP, 2)), key=jax.random.PRNGKey(0), gen=jnp.int32(2))
    jcheckpoint.save_state(js, str(tmp_path), "StyleGAN2_ffhq_d")
    with pytest.raises(ValueError, match="JAX PRNG key"):
        checkpoint.load_state(str(tmp_path), torch.Generator())


def test_load_state_refuses_the_other_devices_stream(tmp_path, rng):
    g = torch.Generator().manual_seed(1)
    checkpoint.save_state(_state(rng), g, str(tmp_path))
    path = tmp_path / checkpoint.STATE_FILE
    with np.load(path) as d:
        fields = {k: d[k] for k in d.files}
    assert str(fields["rng_device"]) == "cpu"
    fields["rng_device"] = np.asarray("cuda")
    with open(path, "wb") as f:
        np.savez(f, **fields)
    with pytest.raises(ValueError, match="'cuda'.*'cpu'"):
        checkpoint.load_state(str(tmp_path), torch.Generator())
