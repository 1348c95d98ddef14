"""Byte-level BPE machinery for the GPT-2 and CLIP tokenizers (host-side,
pure Python).

Reimplements reference gpt2/encoder.py and clip/simple_tokenizer.py without
the `regex`/`ftfy` packages: the \\p{L}/\\p{N} pre-tokenizers are explicit
scanners over `unicodedata` categories with the regexes' match semantics.
"""

from __future__ import annotations

import unicodedata
from functools import lru_cache
from typing import Dict, List, Tuple


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte -> printable-unicode map (reference gpt2/encoder.py:9-27).

    Printable ASCII/latin bytes map to themselves; the rest map to 256+offset
    so every byte has a visible, non-whitespace stand-in character.
    """
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


@lru_cache(maxsize=None)
def _is_letter(ch: str) -> bool:
    return unicodedata.category(ch).startswith("L")


@lru_cache(maxsize=None)
def _is_number(ch: str) -> bool:
    return unicodedata.category(ch).startswith("N")


def _is_space(ch: str) -> bool:
    # \s in the `regex` package: unicode whitespace.
    return ch.isspace()


def _is_other(ch: str) -> bool:
    return not _is_space(ch) and not _is_letter(ch) and not _is_number(ch)


_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
_SPECIALS = ("<|startoftext|>", "<|endoftext|>")


def _special_at(text: str, j: int) -> bool:
    return text.startswith(_SPECIALS[0], j) or text.startswith(_SPECIALS[1], j)


def _run(text: str, i: int, pred) -> int:
    """End of the run of characters from `i` on that satisfy `pred`."""
    n = len(text)
    while i < n and pred(text[i]):
        i += 1
    return i


def pretokenize_gpt2(text: str) -> List[str]:
    """GPT-2 pattern: 's|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+|
    ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+   (reference gpt2/encoder.py:42).

    A left-to-right scanner with the regex's alternation and backtracking
    semantics, including the trailing-whitespace lookahead that leaves the
    last space of a run to fuse with the following word.
    """
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if ch == "'":
            # contractions are case-sensitive literals in the pattern
            c = next((c for c in _CONTRACTIONS if text.startswith(c, i)), None)
            j = i + len(c) if c is not None else _run(text, i, _is_other)
        elif _is_space(ch):
            j = _run(text, i, _is_space)
            if j < n:
                # \s+(?!\S) takes all but the run's last character; a last
                # plain space joins the next token through its " ?" prefix,
                # any other whitespace character stands alone (\s+)
                if j - i > 1:
                    out.append(text[i:j - 1])
                i = j - 1
                if text[i] == " ":
                    nxt = text[j]
                    pred = (_is_letter if _is_letter(nxt) else
                            _is_number if _is_number(nxt) else _is_other)
                    j = _run(text, j, pred)
        elif _is_letter(ch):
            j = _run(text, i, _is_letter)
        elif _is_number(ch):
            j = _run(text, i, _is_number)
        else:
            j = _run(text, i, _is_other)
        out.append(text[i:j])
        i = j
    return out


def pretokenize_clip(text: str) -> List[str]:
    """CLIP pattern: <|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|
    [\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+   (reference clip/simple_tokenizer.py:78).

    findall semantics: unmatched characters (whitespace) are skipped.
    Digits match ONE AT A TIME ([\\p{N}] has no +).
    """
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if _is_space(ch):
            i += 1
            continue
        special = next((s for s in _SPECIALS if text.startswith(s, i)), None)
        if special is not None:
            out.append(special)
            i += len(special)
            continue
        if ch == "'":
            c = next((c for c in _CONTRACTIONS if text.startswith(c, i)), None)
            if c is not None:
                out.append(c)
                i += len(c)
                continue
            # an "other" run starting at "'": stops where a special begins
            j = i
            while j < n and _is_other(text[j]) and not _special_at(text, j):
                j += 1
            out.append(text[i:j])
            i = j
            continue
        if _is_letter(ch):
            j = i
            while j < n and _is_letter(text[j]):
                j += 1
            out.append(text[i:j])
            i = j
            continue
        if _is_number(ch):
            out.append(ch)
            i += 1
            continue
        j = i
        while j < n and _is_other(text[j]):
            if j > i and _special_at(text, j):
                break
            j += 1
        out.append(text[i:j])
        i = j
    return out


def get_pairs(word: Tuple[str, ...]) -> set:
    """Set of adjacent symbol bigrams (reference gpt2/encoder.py:29-37)."""
    return set(zip(word[:-1], word[1:]))


def bpe_merge(token: Tuple[str, ...], bpe_ranks: Dict[Tuple[str, str], int]) -> Tuple[str, ...]:
    """Greedy lowest-rank-first BPE merge loop (reference gpt2/encoder.py:53-83)."""
    word = token
    pairs = get_pairs(word)
    if not pairs:
        return word
    while True:
        bigram = min(pairs, key=lambda p: bpe_ranks.get(p, float("inf")))
        if bigram not in bpe_ranks:
            break
        first, second = bigram
        new_word: List[str] = []
        i = 0
        while i < len(word):
            try:
                j = word.index(first, i)
            except ValueError:
                new_word.extend(word[i:])
                break
            new_word.extend(word[i:j])
            i = j
            if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                new_word.append(first + second)
                i += 2
            else:
                new_word.append(word[i])
                i += 1
        word = tuple(new_word)
        if len(word) == 1:
            break
        pairs = get_pairs(word)
    return word
