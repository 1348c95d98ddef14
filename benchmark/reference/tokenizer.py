"""CLIP's byte-level BPE tokenizer, written out plainly for the benchmark's
reference.

It follows OpenAI CLIP's `simple_tokenizer.py` and `clip.tokenize`: the
text cleaned (`clean`), split by the pattern (`_pieces`), each piece's
UTF-8 bytes merged by `bpe_simple_vocab_16e6.txt.gz` (a frozen copy beside
this file, the first 48,894 merges after the header line), and the 77-token
context `<|startoftext|> ... <|endoftext|>` padded with zeros.

`clean` is `basic_clean` then `whitespace_clean` and lower case, for text of
any script (an image-to-text search's captions): a UTF-8 text that was
decoded as cp1252 or latin-1 is decoded again (the mojibake repair of
`ftfy.fix_text`; ftfy's other repairs, such as straightening curly quotes,
are not made), NFC, HTML entities unescaped twice, runs of whitespace made
one space. The pattern's letter and number classes (`\\p{L}`, `\\p{N}`) are
read from the Unicode categories.
"""

from __future__ import annotations

import gzip
import html
import os
import unicodedata
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

import numpy as np

VOCAB = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bpe_simple_vocab_16e6.txt.gz")
CONTEXT = 77
SPECIALS = ("<|startoftext|>", "<|endoftext|>")
CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _kind(ch: str) -> str:
    """"L" a letter, "N" a number, " " whitespace, "O" anything else."""
    if ch.isspace():
        return " "
    cat = unicodedata.category(ch)[0]
    return cat if cat in "LN" else "O"


def _pieces(text: str) -> List[str]:
    """re.findall of the pattern <|startoftext|>|<|endoftext|>|'s|'t|'re|
    've|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+: at each position the
    first alternative that matches; whitespace between pieces is skipped."""
    out, i = [], 0
    while i < len(text):
        kind = _kind(text[i])
        fixed = next((s for s in SPECIALS + CONTRACTIONS if text.startswith(s, i)), None)
        if fixed is not None:
            j = i + len(fixed)
        elif kind == " ":
            i += 1
            continue
        elif kind == "N":
            j = i + 1
        else:
            j = i + 1
            while j < len(text) and _kind(text[j]) == kind:
                j += 1
        out.append(text[i:j])
        i = j
    return out


def _unmojibake(text: str) -> str:
    """A text whose UTF-8 bytes were decoded as cp1252 (or latin-1) decoded
    again, while that gives valid UTF-8 in fewer characters (three rounds
    at most); any other text as it is."""
    for _ in range(3):
        if text.isascii():
            return text
        for codec in ("cp1252", "latin-1"):
            try:
                raw = text.encode(codec)
                break
            except UnicodeEncodeError:
                raw = None
        if raw is None:
            return text
        try:
            fixed = raw.decode("utf-8")
        except UnicodeDecodeError:
            return text
        if len(fixed) >= len(text):
            return text
        text = fixed
    return text


def clean(text: str) -> str:
    """The text as CLIP's tokenizer reads it: repaired, NFC, unescaped,
    whitespace collapsed, lower case."""
    text = html.unescape(html.unescape(unicodedata.normalize("NFC", _unmojibake(text))))
    return " ".join(text.split()).lower()


def merge(word: Tuple[str, ...], ranks: Dict[Tuple[str, str], int]) -> List[str]:
    """The symbols of `word` after its byte-pair merges: the pair of lowest
    rank merged everywhere it stands, left to right, until no ranked pair
    is left."""
    word = list(word)
    while len(word) > 1:
        pairs = [(ranks.get((a, b), None), i) for i, (a, b) in enumerate(zip(word, word[1:]))]
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


def byte_chars() -> Dict[int, str]:
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
        self.byte_chars = byte_chars()
        vocab = list(self.byte_chars.values())
        vocab += [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.ids = {tok: i for i, tok in enumerate(vocab)}
        self.ranks = {m: i for i, m in enumerate(merges)}
        self.sot, self.eot = self.ids["<|startoftext|>"], self.ids["<|endoftext|>"]

    def encode(self, text: str) -> List[int]:
        out = []
        for piece in _pieces(clean(text)):
            if piece in SPECIALS:
                out.append(self.ids[piece])
                continue
            chars = "".join(self.byte_chars[b] for b in piece.encode("utf-8"))
            word = tuple(chars[:-1]) + (chars[-1] + "</w>",)
            out.extend(self.ids[t] for t in merge(word, self.ranks))
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
