"""clip_glass_torch's tokenizers (GPT-2 byte-level BPE, CLIP BPE and its
77-token packing), on both merge routes (the native core and the Python
loop), against the JAX package's: token-exact on captions with unicode,
contractions, whitespace runs and one that overflows CLIP's context. Also
the native core's build location, and `clip_preprocess_pil` on an example
image against the JAX package's."""

import os
import random

import numpy as np
import pytest

from clip_glass_tpu.ops.resize import clip_preprocess_pil as jpreprocess
from clip_glass_tpu.tokenizers import bpe as jbpe
from clip_glass_tpu.tokenizers import clip_bpe as jclip_bpe
from clip_glass_tpu.tokenizers import gpt2_bpe as jgpt2_bpe

from clip_glass_torch.ops.resize import clip_preprocess_pil
from clip_glass_torch.tokenizers import bpe, clip_bpe, gpt2_bpe, native

DOG = os.path.join(os.path.dirname(__file__), "..", "examples", "gpt2_images", "dog.jpeg")
CAPTIONS = [
    "the picture of a dog",
    "the picture of",
    "Hello, world! It's a dog's life; they'll've   spaced\ttabs\nand lines ",
    "naïve café über 漢字 😀 Ωμέγα — “quotes” ½ ٣",
    "CafÃ© mojibake &amp; html &lt;tags&gt;",
    "numbers 1234567 and 3.14159, x2 2x",
    "",
    " ",
    "⺀" * 50,                           # 50 characters, 150 CLIP tokens: overflows
]
ROUTES = ("native", "python")


@pytest.fixture(scope="module")
def jax_tokenizers():
    return jgpt2_bpe.get_gpt2_tokenizer(), jclip_bpe.get_clip_tokenizer()


def _port(route):
    """Fresh tokenizers on the native core, or with it taken away (the
    Python merge loop)."""
    g, c = gpt2_bpe.GPT2Tokenizer(), clip_bpe.CLIPTokenizer()
    assert g.native is not None and c.native is not None
    if route == "python":
        g.native = c.native = None
    return g, c


@pytest.mark.parametrize("route", ROUTES)
def test_gpt2_encode_decode_match_jax(route, jax_tokenizers):
    jg, _ = jax_tokenizers
    g, _ = _port(route)
    assert g.eot_id == jg.eot_id == 50256
    for text in CAPTIONS:
        ids = g.encode(text)
        assert ids == jg.encode(text), text
        assert g.decode(ids) == text
    # arbitrary ids, including cut UTF-8 sequences (replacement characters)
    rng = np.random.default_rng(0)
    for _ in range(20):
        ids = rng.integers(0, 50257, 12).tolist()
        assert g.decode(ids) == jg.decode(ids)
    assert g.encode("the picture of") == [1169, 4286, 286]


@pytest.mark.parametrize("route", ROUTES)
def test_clip_encode_and_tokenize_match_jax(route, monkeypatch, jax_tokenizers):
    _, jc = jax_tokenizers
    _, c = _port(route)
    for text in CAPTIONS:
        assert c.encode(text) == jc.encode(text), text
    fits = CAPTIONS[:-1]
    monkeypatch.setattr(clip_bpe, "get_clip_tokenizer", lambda: c)
    np.testing.assert_array_equal(clip_bpe.tokenize(fits), jclip_bpe.tokenize(fits))
    for tokenize in (clip_bpe.tokenize, jclip_bpe.tokenize):
        with pytest.raises(RuntimeError, match="too long"):
            tokenize(CAPTIONS)


def test_pretokenize_gpt2_matches_jax_on_random_text():
    """The GPT-2 scanner on random strings over letters, digits, marks,
    quotes, contractions and several kinds of whitespace."""
    alphabet = list("ab Z9'\t\n é漢٣!?.,—") + [" ", "  ", "'s", "'re", "'ll", "　"]
    rnd = random.Random(0)
    for _ in range(3000):
        text = "".join(rnd.choice(alphabet) for _ in range(rnd.randint(0, 14)))
        assert bpe.pretokenize_gpt2(text) == jbpe.pretokenize_gpt2(text), repr(text)


def test_native_core_builds_under_build_not_beside_the_source(monkeypatch):
    lib = native.load_library()
    assert lib is not None
    path = native.library_path()
    assert path.exists() and path.parent.parts[-2:] == ("build", "clip_glass_torch")
    assert not [f for f in os.listdir(native.SOURCE.parent) if f.endswith(".so")]
    merger = native.get_native_merger({"a": 0, "b": 1, "ab": 2}, {("a", "b"): 0})
    assert merger.apply([0, 1, 0, 1, 1]) == [2, 2, 1] and merger.apply([]) == []
    # a core that cannot be built leaves the tokenizers on the Python loop
    monkeypatch.setattr(native, "load_library", lambda: None)
    assert native.get_native_merger({"a": 0}, {}) is None
    assert gpt2_bpe.GPT2Tokenizer().native is None and clip_bpe.CLIPTokenizer().native is None


def test_clip_preprocess_pil_matches_jax():
    from PIL import Image

    with Image.open(DOG) as im:
        for size in (224, 32):
            got, want = clip_preprocess_pil(im, size), jpreprocess(im, size)
            assert got.shape == (1, 3, size, size) and got.dtype == np.float32
            np.testing.assert_array_equal(got, want)
