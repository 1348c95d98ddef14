"""CLIP's byte-level BPE tokenizer, written out plainly for the benchmark's
reference.

It follows OpenAI CLIP's `simple_tokenizer.py` and `clip.tokenize`: lower
case, whitespace collapsed, the pattern
`'s|'t|'re|'ve|'m|'ll|'d|[letters]+|[digit]|[^space letter digit]+`, the
merges of `bpe_simple_vocab_16e6.txt.gz` (a frozen copy beside this file,
the first 48,894 merges after the header line), and the 77-token context
`<|startoftext|> ... <|endoftext|>` padded with zeros. The benchmark's
prompts are ASCII, for which the pattern above is exact with Python's `re`
and the text clean-up (ftfy, HTML unescape) is the identity; other text is
refused.
"""

from __future__ import annotations

import gzip
import os
import re
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

import numpy as np

VOCAB = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bpe_simple_vocab_16e6.txt.gz")
CONTEXT = 77
_PATTERN = re.compile(r"'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+")


def _byte_chars() -> Dict[int, str]:
    """GPT-2's reversible map of the 256 bytes to printable characters."""
    keep = list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1)) \
        + list(range(ord("\xae"), ord("\xff") + 1))
    chars = keep[:]
    extra = 0
    for b in range(256):
        if b not in keep:
            keep.append(b)
            chars.append(256 + extra)
            extra += 1
    return dict(zip(keep, (chr(c) for c in chars)))


class Tokenizer:
    def __init__(self, path: str = VOCAB):
        with gzip.open(path) as f:
            lines = f.read().decode("utf-8").split("\n")
        merges = [tuple(m.split()) for m in lines[1:49152 - 256 - 2 + 1]]
        self.byte_chars = _byte_chars()
        vocab = list(self.byte_chars.values())
        vocab += [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.ids = {tok: i for i, tok in enumerate(vocab)}
        self.ranks = {m: i for i, m in enumerate(merges)}
        self.sot, self.eot = self.ids["<|startoftext|>"], self.ids["<|endoftext|>"]

    def _merge(self, word: Tuple[str, ...]) -> List[str]:
        word = list(word)
        while len(word) > 1:
            pairs = [(self.ranks.get((a, b), None), i)
                     for i, (a, b) in enumerate(zip(word, word[1:]))]
            ranked = [p for p in pairs if p[0] is not None]
            if not ranked:
                break
            best = min(ranked)[0]
            first, second = next((word[i], word[i + 1]) for r, i in ranked if r == best)
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        return word

    def encode(self, text: str) -> List[int]:
        if not text.isascii():
            raise ValueError(f"the reference tokenizer takes ASCII prompts: {text!r}")
        text = " ".join(text.split()).lower()
        out = []
        for piece in _PATTERN.findall(text):
            chars = "".join(self.byte_chars[b] for b in piece.encode("utf-8"))
            word = tuple(chars[:-1]) + (chars[-1] + "</w>",)
            out.extend(self.ids[t] for t in self._merge(word))
        return out


@lru_cache(maxsize=1)
def tokenizer() -> Tokenizer:
    return Tokenizer()


def tokenize(texts: Sequence[str]) -> np.ndarray:
    """Texts -> [N, 77] int64 ids (clip.tokenize); a text too long raises."""
    tok = tokenizer()
    out = np.zeros((len(texts), CONTEXT), np.int64)
    for i, t in enumerate(texts):
        ids = [tok.sot] + tok.encode(t) + [tok.eot]
        if len(ids) > CONTEXT:
            raise ValueError(f"prompt {t!r} is longer than {CONTEXT} tokens")
        out[i, :len(ids)] = ids
    return out
