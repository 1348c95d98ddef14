"""The output check: the fitness that the timed path produced, held against
the plain reference (`benchmark/reference/`) on the same genomes, prompts
and weights.

The reference runs once the window has closed and the port's state is
freed, in float32 with TF32 off, one search's population at a time (D's
minibatch groups are a search's own rows, as in the port). It reads the
benchmark's weights, tokenizes each prompt (or reads each target image)
itself and works out every image, feature and logit again. Of an
image-to-text family it takes the port's generator outputs, the decoded
ids, and judges them (families/gpt2.py).

Numbers, each compared where `benchmark/limits/<cell>.json` gives it a
limit (the others are reported to the readings that place the limits):
- `sim_gap`, `sim_gap_mean`, `sim_gap_rms`: the widest gap between the
  port's and the reference's CLIP cosine over the rows checked, the mean
  and the root mean square (a whole-sample number that a few altered rows
  still move: one row off by 0.05 among 256 reads 0.0031 or more);
- `hinge_gap`, `hinge_gap_mean`, `hinge_gap_rms` (with D): the same of D's
  hinge relu(1 - D), each row's gap over max(1, |reference hinge|);
- `decode_margin`, `decode_margin_rms` (image to text): the reference
  teacher-forced on the port's decoded tokens, at each step its largest
  logit minus its logit of the port's token, over the standard deviation
  of the step's logits: the largest over the rows and steps checked, and
  the root mean square (a served token's logit below the reference's
  best, which rounding leaves near 0 and a wrong model or token does not);
  with these, `sim_gap*` hold the port's fitness against the reference's
  for the port's own captions;
- `moved_rows`: the rows of the population that the window replaced; a
  step that leaves its state unchanged reads 0 (limit: at least 1).
Besides, each run prints the draw's saturation (the share of image pixels
at the clip limits, D's largest logit; a family with no image gives no
share) and fails when the draw saturates.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from benchmark.families import family
from benchmark.reference.numerics import fp32_exact

# a draw saturates when half of the image's pixels or more sit at a clip
# limit, so that G's output reaches CLIP and D through fewer pixels than the
# clip keeps from them, or when D's logits leave the range in which bf16 and
# float32 still agree in a hinge
SATURATED_SHARE = 0.5
SATURATED_LOGIT = 1e3


def to_device(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return [to_device(v, device) for v in tree]


@torch.no_grad()
def reference_fitness(config: dict, weights: dict, X: torch.Tensor, targets: List[str],
                      block: int, precision: str = "fp32",
                      outputs: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """F [K, pop, n_obj] of genomes X [K, pop, n_var], search k scored
    against targets[k], with the images' clip share (None without images)
    and D's logits. `precision` "fp8": the control, computed in e4m3
    (reference/numerics.py). `outputs` [K, pop, ...]: the port's generator
    outputs, handed to the family's `score`, which judges them (`margins`
    [rows, steps]); a family that makes such outputs and is handed none
    makes its own (`outputs`)."""
    fam = family(config)
    block = fam.block_rows(config, X.shape[1], block)
    with fp32_exact(precision):
        feats = fam.targets(config, weights, targets, X.device)
        F_rows, clipped, logits, margins, own = [], [], [], [], []
        for k in range(X.shape[0]):
            cols = []
            for r in range(0, X.shape[1], block):
                given = {} if outputs is None else {"outputs": outputs[k, r:r + block]}
                out = fam.score(config, weights, X[k, r:r + block], feats[k:k + 1], **given)
                cols.append(torch.stack(out["cols"], dim=1))
                if out["clipped"] is not None:
                    clipped.append(out["clipped"])
                if out["logits"] is not None:
                    logits.append(out["logits"])
                if out.get("margins") is not None:
                    margins.append(out["margins"])
                if out.get("outputs") is not None:
                    own.append(out["outputs"])
                del out
            F_rows.append(torch.cat(cols))
    return {"F": torch.stack(F_rows),
            "clip_share": torch.stack(clipped).mean() if clipped else None,
            "logit_max": torch.cat(logits).abs().max() if logits else None,
            "margins": torch.cat(margins) if margins else None,
            "outputs": torch.cat(own).reshape(*X.shape[:2], -1) if own else None}


def row_gaps(F_prog: torch.Tensor, F_ref: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Each row's gap between the port's fitness and the reference's: the
    cosine's, and D's hinge over max(1, |reference hinge|)."""
    F_prog, F_ref = F_prog.double(), F_ref.double()
    out = {"sim": (F_prog[..., 0] - F_ref[..., 0]).abs().flatten()}
    if F_ref.shape[-1] > 1:
        out["hinge"] = ((F_prog[..., 1] - F_ref[..., 1]).abs()
                        / F_ref[..., 1].abs().clamp_min(1.0)).flatten()
    return {k: torch.nan_to_num(v, nan=float("inf")) for k, v in out.items()}


def summarize(gaps: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The widest gap of each objective over the rows checked, the mean and
    the root mean square; of the decode margins ("margin", [rows, steps])
    the largest and the root mean square."""
    out = {}
    for k, v in gaps.items():
        if k == "margin":
            out["decode_margin"] = v.max().item()
            out["decode_margin_rms"] = v.square().mean().sqrt().item()
            continue
        out[f"{k}_gap"] = v.max().item()
        out[f"{k}_gap_mean"] = v.mean().item()
        out[f"{k}_gap_rms"] = v.square().mean().sqrt().item()
    return out


def moved_rows(X_start: torch.Tensor, X_end: torch.Tensor) -> int:
    """Rows of the end populations [K, pop, n_var] found in no row of the
    same search's start population."""
    same = (X_end[:, :, None, :] == X_start[:, None, :, :]).all(-1).any(-1)
    return int((~same).sum().item())


def saturated(clip_share: Optional[float], logit_max) -> bool:
    if clip_share is not None and (not math.isfinite(clip_share)
                                   or clip_share > SATURATED_SHARE):
        return True
    return logit_max is not None and not (logit_max <= SATURATED_LOGIT)


def judge(values: Dict[str, float], limits: Dict[str, dict]) -> Dict[str, dict]:
    """Each number beside its limit: {"value", "limit", "ok"}; a limit is
    {"max": x} or {"min": x}."""
    out = {}
    for name, lim in limits.items():
        v = values.get(name)
        if "max" in lim:
            ok, bound = v is not None and v <= lim["max"], lim["max"]
        else:
            ok, bound = v is not None and v >= lim["min"], lim["min"]
        out[name] = {"value": v, "limit": bound, "ok": bool(ok)}
    return out
