"""GPT-2 (124M) in plain PyTorch, float32, as OpenAI's `gpt-2` code (and
CLIP-GLaSS's copy of it, `gpt2/model.py` and `gpt2/sample.py`) computes it:
token and position embeddings; pre-LN blocks (LayerNorm, causal multi-head
attention, a tanh-GELU MLP of four times the width), each adding to the
residual stream; a final LayerNorm; the head tied to the token embedding.
There is no KV cache: every forward runs over the whole sequence under a
causal mask, so a step's logits do not depend on how earlier steps were
computed.

The image-to-text check reads three things from it:
- `margins`: teacher-forced on the port's ids, each decoded step's largest
  logit minus the logit of the token the port took, over the standard
  deviation of that step's logits;
- `decode`: the argmax decode (the control's own, in its precision);
- `captions`: the caption of each row as CLIP-GLaSS makes it
  (`models.py`): the ids after the genome, cut at the first end-of-text id
  anywhere in the row, BPE-decoded, the first `max_chars` characters.

The parameters are the benchmark's tree (`harness/weights.py`) in the
port's layout: `wte` [V, D], `wpe` [P, D], `ln_f`, and `blocks`, a list of
{`ln_1`, `attn` {`c_attn_w` [D, 3D], `c_attn_b`, `c_proj_w`, `c_proj_b`},
`ln_2`, `mlp` {`c_fc_w` [D, 4D], `c_fc_b`, `c_proj_w`, `c_proj_b`}}, each
LayerNorm {`g`, `b`}. The BPE files beside this one are frozen copies of
GPT-2 124M's `encoder.json` and `vocab.bpe`.
"""

from __future__ import annotations

import json
import math
import os
import re
from functools import lru_cache
from typing import List

import torch
import torch.nn.functional as F

from benchmark.reference import numerics as num
from benchmark.reference.tokenizer import byte_chars, merge

HERE = os.path.dirname(os.path.abspath(__file__))
EOT = 50256
# GPT-2's pattern (`encoder.py`), exact for ASCII text
_ASCII_PATTERN = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d| ?[a-zA-Z]+| ?[0-9]+| ?[^\sa-zA-Z0-9]+|\s+(?!\S)|\s+")


def _ln(x, p, eps: float):
    return F.layer_norm(x, x.shape[-1:], p["g"], p["b"], eps)


def _block(x, p, heads: int, eps: float, mask):
    B, T, D = x.shape
    a, m = p["attn"], p["mlp"]
    q, k, v = (num.mm(_ln(x, p["ln_1"], eps), a["c_attn_w"]) + a["c_attn_b"]).split(D, dim=-1)
    q, k, v = (t.reshape(B, T, heads, D // heads).transpose(1, 2) for t in (q, k, v))
    w = torch.softmax(num.mm(q, k.transpose(-1, -2)) / math.sqrt(D // heads) + mask, dim=-1)
    h = num.mm(w, v).transpose(1, 2).reshape(B, T, D)
    x = x + num.mm(h, a["c_proj_w"]) + a["c_proj_b"]
    h = F.gelu(num.mm(_ln(x, p["ln_2"], eps), m["c_fc_w"]) + m["c_fc_b"], approximate="tanh")
    return x + num.mm(h, m["c_proj_w"]) + m["c_proj_b"]


def hidden(params, ids: torch.Tensor, geo: dict) -> torch.Tensor:
    """ids [B, T] -> the final LayerNorm's output [B, T, D]."""
    T = ids.shape[1]
    x = params["wte"][ids] + params["wpe"][:T]
    mask = torch.full((T, T), float("-inf"), device=x.device).triu(1)
    for bp in params["blocks"]:
        x = num.rounded(_block(x, bp, geo["n_head"], geo["layer_norm_epsilon"], mask))
    return _ln(x, params["ln_f"], geo["layer_norm_epsilon"])


def head(params, h: torch.Tensor) -> torch.Tensor:
    """Logits [..., V] of hidden states [..., D] (the tied head)."""
    return num.mm(h, params["wte"].t())


def decode(params, context: torch.Tensor, steps: int, geo: dict) -> torch.Tensor:
    """The argmax decode: context [B, T0] -> [B, T0 + steps], each step's
    token the first of its largest logits."""
    ids = context.long()
    for _ in range(steps):
        nxt = head(params, hidden(params, ids, geo)[:, -1]).argmax(dim=-1)
        ids = torch.cat([ids, nxt[:, None]], dim=1)
    return ids


def margins(params, ids: torch.Tensor, start: int, geo: dict) -> torch.Tensor:
    """Teacher-forced on ids [B, T], whose tokens from `start` on were
    decoded: [B, T - start], each step's largest logit minus the logit of
    the token in ids, over the standard deviation of that step's logits."""
    ids = ids.long()
    logits = head(params, hidden(params, ids[:, :-1], geo)[:, start - 1:])
    taken = logits.gather(-1, ids[:, start:, None])[..., 0]
    return (logits.max(dim=-1).values - taken) / logits.std(dim=-1)


@lru_cache(maxsize=1)
def _bpe():
    """(token -> id, id -> token, merge ranks) of GPT-2's BPE."""
    with open(os.path.join(HERE, "gpt2_encoder.json"), encoding="utf-8") as f:
        ids = json.load(f)
    with open(os.path.join(HERE, "gpt2_vocab.bpe"), encoding="utf-8") as f:
        ranks = {tuple(line.split()): i for i, line in enumerate(f.read().split("\n")[1:-1])}
    return ids, {i: t for t, i in ids.items()}, ranks


def encode(text: str) -> List[int]:
    """GPT-2's BPE ids of an ASCII text (the configuration's init text)."""
    if not text.isascii():
        raise ValueError(f"the reference encodes ASCII text only: {text!r}")
    ids, _, ranks = _bpe()
    chars = byte_chars()
    return [ids[t] for piece in _ASCII_PATTERN.findall(text)
            for t in merge(tuple(chars[b] for b in piece.encode("utf-8")), ranks)]


def captions(ids: torch.Tensor, n_genome: int, max_chars: int) -> List[str]:
    """Each row's caption (the module docstring)."""
    _, tokens, _ = _bpe()
    bytes_of = {c: b for b, c in byte_chars().items()}
    out = []
    for row in ids.tolist():
        end = row.index(EOT) if EOT in row else len(row)
        text = "".join(tokens.get(t, "") for t in row[n_genome:end])
        out.append(bytes(bytes_of[c] for c in text).decode("utf-8", errors="replace")
                   [:max_chars])
    return out
