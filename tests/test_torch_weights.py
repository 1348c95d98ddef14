"""The port's checkpoint converters (clip_glass_torch/weights/convert_*.py)
and its synthesizer (weights/synthesize.py) against the JAX package's, at
TINY sizes on the CPU.

- Each port converter's tree equals the JAX converter's tree on the same
  file: the same keys, the same dtypes, the same bits (np.array_equal), and
  the same config.
- The files come from the independent fixtures the repo has where there is
  one (scripts/synthesize_checkpoints.py's `synth_gpt2` and
  `synth_stylegan2_pkl`, tests/biggan_hf_oracle.py's module tree), and
  the port's synthesizer matches them key for key and shape for shape.
  StyleGAN2's `.pth` and CLIP's `.pt` have no such fixture here: the JAX
  converter reads the port's written state dict through a dict that records
  the keys read, and must read every key written.
- The slice as a whole: TINY StyleGAN2_ffhq_d `eval_population` from a
  reference-layout directory (Gs.pth, D.pth, a CLIP .pt of either tower) in
  both packages, and TINY BigGAN and GPT-2 from their `.bin` files, agree at
  1e-4 of each objective's scale (fp32), as
  test_torch_checkpoint.py::test_converted_checkpoint_fitness_matches_jax.
"""

import dataclasses
import importlib.util
import os
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch

from clip_glass_tpu.config import get_config as jget_config
from clip_glass_tpu.fitness.problem import GenerationProblem as JProblem
from clip_glass_tpu.models.biggan import model as jbg
from clip_glass_tpu.weights import convert_biggan as jconv_biggan
from clip_glass_tpu.weights import convert_clip as jconv_clip
from clip_glass_tpu.weights import convert_gpt2 as jconv_gpt2
from clip_glass_tpu.weights import convert_stylegan2 as jconv_sg2
from clip_glass_tpu.weights import convert_stylegan2_tf as jconv_tf

from clip_glass_torch.config import get_config
from clip_glass_torch.core import pytree
from clip_glass_torch.fitness.problem import GenerationProblem
from clip_glass_torch.models.biggan import model as tbg
from clip_glass_torch.models.clip import model as tclip
from clip_glass_torch.models.stylegan2 import model as tsg2
from clip_glass_torch.weights import (convert_biggan, convert_clip, convert_gpt2,
                                      convert_stylegan2, convert_stylegan2_tf, synthesize)

import biggan_hf_oracle
from torch_parity import N, T, assert_close_scaled

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POP = 8
DOG = os.path.join(REPO, "examples", "gpt2_images", "dog.jpeg")

# TINY geometries of both CLIP tower families (the text tower's width 64
# gives one head: the loaders infer width / 64, as the reference does)
CLIP_VIT = tclip.TINY
CLIP_RN = tclip.CLIPConfig(embed_dim=64, image_resolution=32, vision_layers=(1, 1, 1, 1),
                           vision_width=16, transformer_width=64, transformer_heads=1,
                           transformer_layers=2, vision_kind="rn")


def jax_synth():
    """scripts/synthesize_checkpoints.py (its GPT-2 and TF-pickle writers
    need torch, pickle and numpy only)."""
    spec = importlib.util.spec_from_file_location(
        "synthesize_checkpoints", os.path.join(REPO, "scripts", "synthesize_checkpoints.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def assert_same_tree(got, want):
    """Same flattened keys, dtypes and bits."""
    fg = pytree.flatten(got)
    fw = pytree.flatten(jax.tree.map(np.asarray, want))
    assert sorted(fg) == sorted(fw)
    for k in fw:
        g, w = np.asarray(fg[k]), fw[k]
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, w.dtype, g.shape, w.shape)
        assert np.array_equal(g, w), k


def assert_same_cfg(got, want):
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


class Recording(dict):
    """A state dict that records the keys read by item access."""

    def __init__(self, *a):
        super().__init__(*a)
        self.read = set()

    def __getitem__(self, k):
        self.read.add(k)
        return super().__getitem__(k)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Every format at TINY geometry: the JAX package's fixtures where the
    repo has one, the port's synthesizer otherwise."""
    root = tmp_path_factory.mktemp("reference_layout")
    js = jax_synth()
    out = {"gpt2": str(root / "gpt2-pytorch_model.bin"),
           "tf_pkl": str(root / "stylegan2-tiny.pkl"),
           "biggan": str(root / "biggan-tiny.bin"),
           "sg2_dir": str(root / "stylegan2")}
    js.synth_gpt2(out["gpt2"], n_embd=64)
    js.synth_stylegan2_pkl(out["tf_pkl"])
    torch.save(biggan_hf_oracle.make_random_oracle(jbg.TINY, seed=1).state_dict(), out["biggan"])
    synthesize.write_stylegan2_pth(out["sg2_dir"], tsg2.TINY, seed=3)
    for name, cfg in (("vit", CLIP_VIT), ("rn", CLIP_RN)):
        for jit, dtype in ((True, torch.float16), (False, torch.float32)):
            key = f"clip_{name}_{'jit' if jit else 'plain'}"
            out[key] = str(root / f"{key}.pt")
            synthesize.write_clip(out[key], cfg, seed=4, jit=jit, dtype=dtype)
    return out


CLIP_FILES = ["clip_vit_jit", "clip_vit_plain", "clip_rn_jit", "clip_rn_plain"]


# ------------------------------------------------------------ trees


def test_gpt2_tree_matches_jax(files):
    tree, cfg = convert_gpt2.load_torch_checkpoint(files["gpt2"])
    jtree, jcfg = jconv_gpt2.load_torch_checkpoint(files["gpt2"])
    assert_same_tree(tree, jtree)
    assert_same_cfg(cfg, jcfg)
    assert cfg.n_embd == 64 and cfg.n_head == 2 and cfg.n_layer == 2


def test_gpt2_normalize_keys_matches_jax():
    sd = {"module.transformer.h.0.ln_1.g": 1, "transformer.h.0.attn.c_attn.w": 2,
          "h.1.mlp.c_fc.b": 3, "wte.weight": 4}
    assert convert_gpt2.normalize_keys(sd) == jconv_gpt2.normalize_keys(sd)


def test_stylegan2_tf_trees_match_jax(files):
    got = convert_stylegan2_tf.convert_pkl(files["tf_pkl"])
    want = jconv_tf.convert_pkl(files["tf_pkl"])
    assert list(got) == list(want) == ["G", "D", "Gs"]
    for key in ("G", "Gs"):
        (tree, cfg, noise), (jtree, jcfg, jnoise) = got[key], want[key]
        assert_same_tree(tree, jtree)
        assert_same_cfg(cfg, jcfg)
        assert_same_tree(noise, jnoise)
        assert len(noise) == len(cfg.noise_shapes()) and cfg.mapping_layers == 2
    assert_same_tree(got["D"][0], want["D"][0])
    assert_same_cfg(got["D"][1], want["D"][1])


@pytest.mark.parametrize("model_name", ["auto", "biggan-deep-8"])
def test_biggan_tree_matches_jax(files, model_name, monkeypatch):
    """The spectral-norm fold (an fp32 numpy sigma) agrees bitwise, with the
    geometry read off the shapes and taken from the variant table."""
    monkeypatch.setitem(tbg.CONFIGS, "biggan-deep-8", tbg.TINY)
    monkeypatch.setitem(jbg.CONFIGS, "biggan-deep-8", jbg.TINY)
    tree, cfg = convert_biggan.load_torch_checkpoint(files["biggan"], model_name)
    jtree, jcfg = jconv_biggan.load_torch_checkpoint(files["biggan"], model_name)
    assert_same_tree(tree, jtree)
    assert_same_cfg(cfg, jcfg)
    assert_same_cfg(cfg, tbg.TINY)


@pytest.mark.parametrize("stem", ["Gs", "G", "D"])
def test_stylegan2_pth_tree_matches_jax(files, stem):
    path = os.path.join(files["sg2_dir"], f"{stem}.pth")
    tree, cfg, kind = convert_stylegan2.load_pth(path)
    jtree, jcfg, jkind = jconv_sg2.load_pth(path)
    assert kind == jkind == ("D" if stem == "D" else "G")
    assert_same_tree(tree, jtree)
    assert_same_cfg(cfg, jcfg)
    if stem == "D":  # D's kwargs carry no latent or mapping geometry
        assert cfg.channels == tsg2.TINY.channels and cfg.mbstd_group_size == 2
    else:  # nor G's the minibatch-stddev group
        assert cfg == dataclasses.replace(tsg2.TINY, mbstd_group_size=4)


@pytest.mark.parametrize("name", CLIP_FILES)
def test_clip_tree_matches_jax(files, name):
    """Both ingestion paths (TorchScript archive, pickled state dict), fp16
    archives widened to fp32, both tower families."""
    tree, cfg = convert_clip.load_torch_checkpoint(files[name])
    jtree, jcfg = jconv_clip.load_torch_checkpoint(files[name])
    assert_same_tree(tree, jtree)
    assert_same_cfg(cfg, jcfg)
    want = CLIP_RN if "_rn_" in name else CLIP_VIT
    assert cfg == dataclasses.replace(want, transformer_heads=1)


# ------------------------------------------------------------ the written keys


@pytest.mark.parametrize("stem", ["Gs", "D"])
def test_stylegan2_pth_keys_are_all_read_by_jax(files, stem):
    state = torch.load(os.path.join(files["sg2_dir"], f"{stem}.pth"), weights_only=False)
    if stem == "D":
        sd = Recording(state["state_dict"])
        jconv_sg2.convert_discriminator(sd, jconv_sg2.config_from_kwargs(state["kwargs"]))
    else:
        flat = {f"G_mapping.{k}": v for k, v in state["G_mapping"]["state_dict"].items()}
        flat.update({f"G_synthesis.{k}": v for k, v in state["G_synthesis"]["state_dict"].items()})
        flat.update(state["state_dict"])
        sd = Recording(flat)
        jconv_sg2.convert_generator(sd, jconv_sg2.config_from_kwargs(
            state["G_synthesis"]["kwargs"], state["G_mapping"]["kwargs"]))
    assert sd.read == set(sd)


@pytest.mark.parametrize("name", ["clip_vit_jit", "clip_rn_plain"])
def test_clip_keys_are_all_read_by_jax(files, name):
    """Every written entry is read, but for the archives' three scalars,
    which both packages drop."""
    if name.endswith("_jit"):
        raw = torch.jit.load(files[name]).state_dict()
    else:
        raw = torch.load(files[name], weights_only=True)
    sd = convert_clip.read_state_dict(files[name])
    assert set(raw) - set(sd) == set(convert_clip.SCALAR_ENTRIES)
    rec = Recording(sd)
    jconv_clip.convert(rec)
    assert rec.read == set(rec)


# ------------------------------------------------------------ the synthesizer


def _shapes(sd):
    return [(k, tuple(v.shape)) for k, v in sd.items()]


def test_synthesized_gpt2_matches_the_jax_fixture(tmp_path):
    jax_synth().synth_gpt2(str(tmp_path / "j.bin"), n_embd=32, n_layer=3, seed=2)
    synthesize.write_gpt2(str(tmp_path / "t.bin"), n_embd=32, n_layer=3, seed=2)
    want, got = (torch.load(tmp_path / f"{s}.bin", weights_only=True) for s in "jt")
    assert _shapes(got) == _shapes(want)


def _net_layout(net):
    return (net.build_func_name, net.static_kwargs,
            [(n, np.shape(v), np.asarray(v).dtype) for n, v in net.variables],
            {k: _net_layout(c) for k, c in net.components.items()})


def test_synthesized_tf_pickle_matches_the_jax_fixture(tmp_path):
    jax_synth().synth_stylegan2_pkl(str(tmp_path / "j.pkl"), latent=16, channels=(8, 12, 4))
    synthesize.write_stylegan2_pkl(str(tmp_path / "t.pkl"), latent=16, channels=(8, 12, 4))
    want = convert_stylegan2_tf.load_tf_pickle(str(tmp_path / "j.pkl"))
    got = convert_stylegan2_tf.load_tf_pickle(str(tmp_path / "t.pkl"))
    assert [_net_layout(n) for n in got] == [_net_layout(n) for n in want]


def test_synthesized_biggan_matches_the_oracle():
    """The state dict of the package's module tree (tests/biggan_hf_oracle),
    key for key in its order, shape for shape; u and v are unit vectors and
    sigma is near each weight's top singular value."""
    cfg = dataclasses.replace(jbg.TINY, attention_layer_position=1)
    want = biggan_hf_oracle.make_random_oracle(cfg, seed=0).state_dict()
    got = synthesize.biggan_state_dict(
        dataclasses.replace(tbg.TINY, attention_layer_position=1), seed=0)
    assert _shapes(got) == _shapes(want)
    w = got["generator.conv_to_rgb.weight_orig"]
    u, v = got["generator.conv_to_rgb.weight_u"], got["generator.conv_to_rgb.weight_v"]
    sigma = float(u @ w.reshape(w.shape[0], -1) @ v)
    top = float(torch.linalg.matrix_norm(w.reshape(w.shape[0], -1), ord=2))
    assert abs(float(u.norm()) - 1) < 1e-6 and abs(float(v.norm()) - 1) < 1e-6
    assert 0.9 * top < sigma <= top * (1 + 1e-5)
    assert (got["generator.bn.running_vars"] >= 0.5).all()


def test_synthesized_tf_pickle_loads_without_dnnlib(tmp_path):
    """The pickle names dnnlib's Network class, which the stub unpickler
    stands in for."""
    synthesize.write_stylegan2_pkl(str(tmp_path / "t.pkl"))
    with open(tmp_path / "t.pkl", "rb") as f:
        assert b"dnnlib.tflib.network" in f.read()
    nets = convert_stylegan2_tf.load_tf_pickle(str(tmp_path / "t.pkl"))
    assert [type(n) for n in nets] == [convert_stylegan2_tf.TFNetworkStub] * 3
    with pytest.raises(pickle.UnpicklingError):
        convert_stylegan2_tf.load_tf_pickle(__file__)


# ------------------------------------------------------------ the slice


def _sg2_config(get, weights):
    return get("StyleGAN2_ffhq_d").replace(
        pop_size=POP, batch_size=4, dim_z=32, n_var=32, weights=weights,
        target="a red flower", compute_dtype="float32")


@pytest.mark.parametrize("clip_file", ["clip_vit_jit", "clip_rn_plain"])
def test_reference_layout_fitness_matches_jax(files, clip_file):
    """Gs.pth + D.pth + a CLIP .pt, loaded straight by both packages'
    Generators. Neither checkpoint holds noise planes and the packages draw
    them from different generators, so the port takes the JAX package's."""
    jprob = JProblem(_sg2_config(jget_config, files["sg2_dir"]), clip_weights=files[clip_file])
    tprob = GenerationProblem(_sg2_config(get_config, files["sg2_dir"]), device="cpu",
                              clip_weights=files[clip_file])
    jgen, tgen = jprob.generator, tprob.generator
    assert tgen.clip_cfg.vision_kind == ("rn" if "_rn_" in clip_file else "vit")
    assert_same_cfg(tgen.model_cfg, jgen.model_cfg)
    assert [np.ndim(n) for n in jgen.noise] == [2] * len(jgen.noise)
    tgen.noise = [T(n) for n in jgen.noise]
    X = np.random.default_rng(0).normal(size=(POP, 32)).astype(np.float32)
    want = np.asarray(jax.jit(jgen.eval_population)(jnp.asarray(X), jgen.bundle))
    got = N(tgen.eval_population(T(X)))
    assert got.shape == (POP, 2) and np.isfinite(got).all()
    for j in range(2):
        assert_close_scaled(got[:, j], want[:, j], 1e-4)


def test_biggan_bin_fitness_matches_jax(files, monkeypatch):
    """TINY BigGAN from the package's .bin (read as `biggan-deep-<res>`, as
    the JAX package's Generator does) with a CLIP .pt, in both packages."""
    monkeypatch.setitem(tbg.CONFIGS, "biggan-deep-8", tbg.TINY)
    monkeypatch.setitem(jbg.CONFIGS, "biggan-deep-8", jbg.TINY)

    def config(get):
        return get("DeepMindBigGAN512").replace(
            pop_size=POP, dim_z=16, num_classes=10, n_var=26, resolution=8,
            weights=files["biggan"], target="a red flower", compute_dtype="float32")

    jgen = JProblem(config(jget_config), clip_weights=files["clip_vit_plain"]).generator
    tgen = GenerationProblem(config(get_config), device="cpu",
                             clip_weights=files["clip_vit_plain"]).generator
    assert tgen.model_cfg == tbg.TINY
    rng = np.random.default_rng(6)
    X = np.concatenate([rng.normal(size=(POP, 16)), rng.uniform(size=(POP, 10)) < 0.3],
                       1).astype(np.float32)
    want = np.asarray(jax.jit(jgen.eval_population)(jnp.asarray(X), jgen.bundle))
    got = N(tgen.eval_population(T(X)))
    assert got.shape == (POP, 1) and np.isfinite(got).all()
    assert_close_scaled(got, want, 1e-4)


def test_gpt2_bin_fitness_matches_jax(files):
    """TINY GPT-2 from the legacy .bin, the example photo as target, a
    CLIP .pt: the decoded ids token-exact, F at 1e-4 of its scale."""
    def config(get):
        return get("GPT2").replace(pop_size=POP, batch_size=POP, dim_z=6, n_var=6,
                                   max_tokens_len=5, weights=files["gpt2"], target=DOG,
                                   compute_dtype="float32")

    jgen = JProblem(config(jget_config), clip_weights=files["clip_vit_jit"]).generator
    tgen = GenerationProblem(config(get_config), device="cpu",
                             clip_weights=files["clip_vit_jit"]).generator
    X = np.random.default_rng(1).integers(0, 50257, (POP, 6)).astype(np.float32)
    np.testing.assert_array_equal(N(tgen.generate(T(X))).astype(np.int64),
                                  np.asarray(jgen.generate(jnp.asarray(X), jgen.bundle)))
    want = np.asarray(jgen.host_eval_population(jnp.asarray(X), jgen.bundle))
    got = N(tgen.eval_population(T(X)))
    assert got.shape == (POP, 1) and np.isfinite(got).all()
    assert_close_scaled(got, want, 1e-4)
