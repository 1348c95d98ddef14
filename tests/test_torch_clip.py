"""clip_glass_torch CLIP towers and tokenizer against the JAX package's, on
the TINY config in fp32 (weights from the JAX init, carried across with
weights/from_jax.py). Both sides compute in fp32; tolerance 1e-4 relative to
the output's scale (12 matmuls deep, summation order differs)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch

from clip_glass_tpu.core.dtypes import FP32 as JFP32
from clip_glass_tpu.models.clip import model as jclip
from clip_glass_tpu.tokenizers import tokenize as jtokenize

from clip_glass_torch.core.dtypes import FP32
from clip_glass_torch.models.clip import model as tclip
from clip_glass_torch.tokenizers import tokenize as ttokenize
from clip_glass_torch.weights import from_jax

from torch_parity import N, T, assert_close_scaled

PROMPTS = [
    "the face of a man with brown eyes",
    "a red flower",
    "A PHOTO of 3 dogs, 12 cats & one bird!!",
    "café déjà vu — naïve",
    "it's what we'll do &amp; they'd've <|endoftext|> done",
    "CafÃ© mojibake",
    "   spaced\tout \n text  ",
]


@pytest.fixture(scope="module")
def params():
    jp = jclip.init(jax.random.PRNGKey(0), jclip.TINY)
    # non-trivial LayerNorm parameters (the init leaves them at 1 / 0)
    rng = np.random.default_rng(5)

    def f(path, leaf):
        names = [getattr(p, "key", "") for p in path]
        if any(str(n).startswith("ln_") for n in names):
            return leaf + jnp.asarray(rng.normal(size=np.shape(leaf)).astype(np.float32) * 0.1)
        return leaf
    jp = jax.tree_util.tree_map_with_path(f, jp)
    return jp, from_jax.convert_clip(jax.tree.map(np.asarray, jp))


def test_tokenize_matches_jax():
    want = jtokenize(PROMPTS)
    got = ttokenize(PROMPTS)
    assert got.dtype == np.int32 and got.shape == (len(PROMPTS), 77)
    np.testing.assert_array_equal(got, want)


def test_tokenize_overflow_raises():
    with pytest.raises(RuntimeError):
        ttokenize(["word " * 80])


def test_encode_image_matches_jax(params, rng):
    jp, tp = params
    img = rng.uniform(size=(3, 3, 32, 32)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: jclip.encode_image(p, x, jclip.TINY, JFP32))(
        jp, jnp.asarray(img)))
    got = N(tclip.encode_image(tp, T(img), tclip.TINY, FP32))
    assert got.shape == (3, 64)
    assert_close_scaled(got, want, 1e-4)


def test_encode_text_matches_jax(params):
    jp, tp = params
    ids = jtokenize(PROMPTS[:4])
    want = np.asarray(jax.jit(lambda p, t: jclip.encode_text(p, t, jclip.TINY, JFP32))(
        jp, jnp.asarray(ids)))
    got = N(tclip.encode_text(tp, torch.as_tensor(ids), tclip.TINY, FP32))
    assert got.shape == (4, 64)
    assert_close_scaled(got, want, 1e-4)


def test_port_config_matches_jax():
    for a, b in [(jclip.VIT_B_32, tclip.VIT_B_32), (jclip.TINY, tclip.TINY)]:
        for name in ("embed_dim", "image_resolution", "vision_layers",
                     "vision_width", "vision_patch_size", "context_length",
                     "vocab_size", "transformer_width", "transformer_heads",
                     "transformer_layers", "vision_heads", "grid"):
            assert getattr(a, name) == getattr(b, name), name


def test_port_init_matches_jax_structure(params):
    jp, tp = params
    port = tclip.init(torch.Generator().manual_seed(0), tclip.TINY)

    def shapes(t, path=()):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from shapes(t[k], path + (k,))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                yield from shapes(v, path + (i,))
        else:
            yield path, tuple(t.shape)

    assert list(shapes(port)) == list(shapes(tp))
    assert port["logit_scale"].item() == pytest.approx(float(np.log(1 / 0.07)))


def test_api_load_matches_the_models_and_jax_api(tmp_path):
    """models/clip/api.py: `load("random:<seed>")` and `load(<converted
    .npz>)` give the same towers as the model functions on the same
    parameters; the image path of `preprocess` is the JAX API's; the model
    registry and the checkpoint hash check match the JAX API's."""
    import dataclasses
    import json

    from PIL import Image

    from clip_glass_tpu.models.clip import api as japi

    from clip_glass_torch.core import pytree
    from clip_glass_torch.models.clip import api as tapi

    model = tapi.load("random:3", cfg=tclip.TINY, device="cpu")
    want = tclip.init(torch.Generator().manual_seed(3), tclip.TINY)
    ids = ttokenize(PROMPTS[:3])
    torch.testing.assert_close(model.encode_text(ids), tclip.encode_text(
        want, torch.as_tensor(ids), tclip.TINY), rtol=0, atol=0)
    path = tmp_path / "clip.npz"
    pytree.save_npz(str(path), tclip.init_tree(torch.Generator().manual_seed(3), tclip.TINY))
    with open(tmp_path / "clip_cfg.json", "w") as f:
        json.dump(dataclasses.asdict(tclip.TINY), f)
    loaded = tapi.load(str(path), device="cpu")
    assert loaded.cfg == tclip.TINY
    with Image.open("examples/gpt2_images/dog.jpeg") as im:
        img = loaded.preprocess(im)
        np.testing.assert_array_equal(img, japi.LoadedCLIP(None, jclip.TINY, JFP32).preprocess(im))
    torch.testing.assert_close(loaded.encode_image(img), model.encode_image(img),
                               rtol=0, atol=0)
    assert tapi.available_models() == japi.available_models()
    (tmp_path / "x.pt").write_bytes(b"not a checkpoint")
    assert tapi.verify_checkpoint(str(tmp_path / "x.pt"), "ViT-B/32") is False
    with pytest.raises(KeyError):
        tapi.verify_checkpoint(str(tmp_path / "x.pt"), "ViT-L/14")
