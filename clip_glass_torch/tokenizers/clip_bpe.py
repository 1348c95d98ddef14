"""CLIP BPE tokenizer + `tokenize` context packing.

Reimplements reference clip/simple_tokenizer.py:10-132 and the 77-token
context packing of reference clip/clip.py:125-138, with a dependency-free
stand-in for `ftfy.fix_text` (UTF-8 mojibake repair, then NFC
normalization), which is the identity on well-formed input. The merge loop
runs in the native core (tokenizers/native.py) unless the core cannot be
built; both routes give the same ids.
"""

from __future__ import annotations

import gzip
import html
import os
import unicodedata
from functools import lru_cache
from typing import Dict, List, Sequence, Union

import numpy as np

from clip_glass_torch.tokenizers.bpe import bpe_merge, bytes_to_unicode, pretokenize_clip
from clip_glass_torch.tokenizers.native import get_native_merger

_ASSET_DIR = os.path.join(os.path.dirname(__file__), "assets")

CONTEXT_LENGTH = 77
SPECIALS = ("<|startoftext|>", "<|endoftext|>")


def fix_mojibake(text: str, max_rounds: int = 3) -> str:
    """Repair UTF-8 mojibake (the dominant `ftfy.fix_text` case): text whose
    UTF-8 bytes were decoded as cp1252/latin-1 re-encodes losslessly and
    decodes as valid UTF-8 with FEWER codepoints; well-formed text fails one
    of those gates and passes through untouched."""
    for _ in range(max_rounds):
        if all(ord(c) < 0x80 for c in text):
            return text
        try:
            raw = text.encode("cp1252")
        except UnicodeEncodeError:
            try:
                raw = text.encode("latin-1")
            except UnicodeEncodeError:
                return text
        try:
            fixed = raw.decode("utf-8")
        except UnicodeDecodeError:
            return text
        if len(fixed) >= len(text):
            return text
        text = fixed
    return text


def basic_clean(text: str) -> str:
    text = fix_mojibake(text)
    text = unicodedata.normalize("NFC", text)
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return " ".join(text.split())


class CLIPTokenizer:
    def __init__(self, bpe_path: str = None):
        bpe_path = bpe_path or os.path.join(_ASSET_DIR, "bpe_simple_vocab_16e6.txt.gz")
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(bpe_path) as f:
            merges = f.read().decode("utf-8").split("\n")
        # reference simple_tokenizer.py:67: first line is a version header,
        # merges truncated to 49152-256-2 = 48894 entries.
        merges = merges[1: 49152 - 256 - 2 + 1]
        merge_pairs = [tuple(m.split()) for m in merges]
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merge_pairs)
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder: Dict[str, int] = dict(zip(vocab, range(len(vocab))))
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merge_pairs, range(len(merge_pairs))))
        self._cache: Dict[str, str] = {s: s for s in SPECIALS}
        self._id_cache: Dict[str, List[int]] = {}
        self.native = get_native_merger(self.encoder, self.bpe_ranks)

    @property
    def sot_id(self) -> int:
        return self.encoder["<|startoftext|>"]

    @property
    def eot_id(self) -> int:
        return self.encoder["<|endoftext|>"]

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        # word-final marker: last char carries "</w>" (simple_tokenizer.py:81)
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        if len(word) == 1 and word[0] not in self.bpe_ranks:
            out = token + "</w>"
        else:
            out = " ".join(bpe_merge(word, self.bpe_ranks))
        self._cache[token] = out
        return out

    def _token_ids(self, token: str) -> List[int]:
        out = self._id_cache.get(token)
        if out is None:
            if self.native is not None and token not in SPECIALS:
                # the word-final symbol carries "</w>", as in _bpe
                out = self.native.apply([self.encoder[c] for c in token[:-1]]
                                        + [self.encoder[token[-1] + "</w>"]])
            else:
                out = [self.encoder[t] for t in self._bpe(token).split(" ")]
            self._id_cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in pretokenize_clip(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self._token_ids(token))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder.get(int(t), "") for t in ids)
        return bytearray(self.byte_decoder[c] for c in text).decode(
            "utf-8", errors="replace").replace("</w>", " ")


@lru_cache()
def get_clip_tokenizer() -> CLIPTokenizer:
    return CLIPTokenizer()


def tokenize(texts: Union[str, Sequence[str]],
             context_length: int = CONTEXT_LENGTH) -> np.ndarray:
    """Pack texts into a fixed [N, 77] int32 context (reference clip/clip.py:125-138).

    Raises RuntimeError when a text exceeds the context, like the reference.
    """
    if isinstance(texts, str):
        texts = [texts]
    tok = get_clip_tokenizer()
    sot, eot = tok.sot_id, tok.eot_id
    all_tokens = [[sot] + tok.encode(t) + [eot] for t in texts]
    result = np.zeros((len(all_tokens), context_length), dtype=np.int32)
    for i, tokens in enumerate(all_tokens):
        if len(tokens) > context_length:
            raise RuntimeError(
                f"Input {texts[i]!r} is too long for context length {context_length}")
        result[i, : len(tokens)] = tokens
    return result
