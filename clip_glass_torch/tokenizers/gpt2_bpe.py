"""GPT-2 byte-level BPE tokenizer (reference gpt2/encoder.py:40-115).

Reads the standard `encoder.json` (token -> id) and `vocab.bpe` (merges) of
GPT-2 124M, the port's own copies under `assets/`. Host-side: the img2txt
search decodes pop captions of ~50 characters with it each generation. The
merge loop runs in the native core (tokenizers/native.py) unless the core
cannot be built; both routes give the same ids.
"""

from __future__ import annotations

import json
import os
from functools import lru_cache
from typing import Dict, List

from clip_glass_torch.tokenizers.bpe import bpe_merge, bytes_to_unicode, pretokenize_gpt2
from clip_glass_torch.tokenizers.native import get_native_merger

_ASSET_DIR = os.path.join(os.path.dirname(__file__), "assets")


class GPT2Tokenizer:
    def __init__(self, encoder_path: str = None, vocab_path: str = None,
                 errors: str = "replace"):
        encoder_path = encoder_path or os.path.join(_ASSET_DIR, "gpt2_encoder.json")
        vocab_path = vocab_path or os.path.join(_ASSET_DIR, "gpt2_vocab.bpe")
        with open(encoder_path, "r", encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.errors = errors
        self.byte_encoder = bytes_to_unicode()
        # decode at C speed: each token character -> the latin-1 character
        # of its byte value
        self._decode_trans = str.maketrans(
            {c: chr(b) for b, c in self.byte_encoder.items()})
        with open(vocab_path, "r", encoding="utf-8") as f:
            merges = [tuple(line.split()) for line in f.read().split("\n")[1:-1]]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self._id_cache: Dict[str, List[int]] = {}
        self.native = get_native_merger(self.encoder, self.bpe_ranks)

    @property
    def eot_id(self) -> int:
        return self.encoder["<|endoftext|>"]

    def _token_ids(self, token: str) -> List[int]:
        out = self._id_cache.get(token)
        if out is None:
            if self.native is not None:
                out = self.native.apply([self.encoder[c] for c in token])
            else:
                out = [self.encoder[t] for t in bpe_merge(tuple(token), self.bpe_ranks)]
            self._id_cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for token in pretokenize_gpt2(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self._token_ids(token))
        return ids

    def decode(self, ids) -> str:
        text = "".join(self.decoder.get(int(t), "") for t in ids)
        return text.translate(self._decode_trans).encode("latin-1").decode(
            "utf-8", errors=self.errors)


@lru_cache()
def get_gpt2_tokenizer() -> GPT2Tokenizer:
    return GPT2Tokenizer()
