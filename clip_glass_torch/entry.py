"""The two contract entry points of the port, the counterparts of the JAX
package's `__graft_entry__.py`:

- `entry(device=None)`: the flagship fitness forward, the StyleGAN2_ffhq_d
  population evaluation (config-f 1024 px G and D, CLIP ViT-B/32, random
  weights from seed 0, bf16) at pop 4. Returns `(fn, (X, bundle))` with
  `fn(X, bundle) -> F [4, 2]`; X is the JAX entry's draw,
  `np.random.default_rng(0).normal(size=(4, 512))` as float32.
- `dryrun_multichip(n, ...)`: the multi-card dry run
  (`parallel/dryrun.py`).

The evaluation runs on the card unless `device="cpu"`; without a card it
raises. `compute_dtype="float32"` evaluates in fp32 (the agreement checks:
tests/test_torch_bench.py, scripts/entry_agreement_torch.py).
"""

from __future__ import annotations

import numpy as np
import torch

from clip_glass_torch.parallel.dryrun import dryrun_multichip

__all__ = ["entry", "dryrun_multichip"]


def entry(device=None, compute_dtype: str = "bfloat16"):
    from clip_glass_torch.config import get_config
    from clip_glass_torch.fitness.problem import GenerationProblem

    config = get_config("StyleGAN2_ffhq_d").replace(
        target="the face of a man with brown eyes", weights="random:0", pop_size=4,
        compute_dtype=compute_dtype)
    gen = GenerationProblem(config, device=device).generator

    def fn(X, bundle):
        return gen.eval_population(X, bundle)

    X = np.random.default_rng(0).normal(size=(4, config.n_var)).astype(np.float32)
    return fn, (torch.from_numpy(X).to(gen.device), gen.bundle)
