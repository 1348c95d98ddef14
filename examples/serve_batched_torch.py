#!/usr/bin/env python
"""Several text prompts over one weight set, batched in one run (the
PyTorch/CUDA port's `evolve.batched`).

The reference serves one `--target` per process (reference run.py:22).
Here K searches share the problem's weights and each generation evaluates
all K populations at once (G and CLIP at batch K*pop, D's minibatch-std
groups per search); search i searches as an independent run seeded
`search_generator(seed, i)` (tests/test_torch_batched.py).
`--search-microbatch` evaluates the searches in chunks of that many.

  python examples/serve_batched_torch.py --tiny --device cpu \\
      --prompt "a red flower" --prompt "a blue car"
  python examples/serve_batched_torch.py          # full width on the card
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--prompt", action="append", default=None,
                    help="repeatable; one search per prompt")
    ap.add_argument("--config", default="StyleGAN2_ffhq_d")
    ap.add_argument("--generations", type=int, default=8)
    ap.add_argument("--search-microbatch", type=int, default=None)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--weights", default="random:0")
    ap.add_argument("--out", default="./tmp_serve_batched_torch")
    args = ap.parse_args()
    prompts = args.prompt or ["a red flower", "a blue car", "an old house"]

    import numpy as np
    import torch

    from clip_glass_torch.config import get_config
    from clip_glass_torch.evolve.batched import make_batched, minimize_batched
    from clip_glass_torch.evolve.decision import pick
    from clip_glass_torch.evolve.nds import non_dominated_rank
    from clip_glass_torch.fitness.problem import GenerationProblem

    config = get_config(args.config).replace(target=prompts[0], weights=args.weights)
    clip_cfg = model_cfg = None
    if args.tiny:
        from clip_glass_torch.cli import _tinyfy
        config, clip_cfg, model_cfg = _tinyfy(config)

    # one problem (one weight set), K searches
    problem = GenerationProblem(config, device=args.device, clip_cfg=clip_cfg,
                                model_cfg=model_cfg)
    balgo = make_batched(problem, prompts, search_microbatch=args.search_microbatch)
    results = minimize_batched(balgo, n_gen=args.generations, generators=config.seed,
                               save_each=4, verbose=True)

    os.makedirs(args.out, exist_ok=True)
    for i, (prompt, res) in enumerate(zip(prompts, results)):
        pop_X, pop_F = res.pop_X.numpy(), res.pop_F.numpy()
        if config.n_obj == 2:
            # decision on the rank-0 front only (reference run.py:103-113)
            front = (non_dominated_rank(res.pop_F) == 0).numpy()
            X_best = np.atleast_2d(pop_X[front][pick(pop_F[front], (0, 1))])
        else:
            X_best = np.atleast_2d(pop_X[pop_F[:, 0].argmin()])
        path = os.path.join(args.out, f"search-{i:02d}.jpg")
        problem.generator.save(
            problem.generator.render(torch.from_numpy(X_best).to(problem.device)), path)
        print(f"[{i}] {prompt!r}: best sim {-float(pop_F[:, 0].min()):.4f} -> {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
