#!/usr/bin/env python
"""Programmatic API of the PyTorch/CUDA port: a CLIP-guided latent search
without the CLI, then K searches batched in one run.

The reference's workflow (reference run.py:53-125) in the port's own API:
config registry -> GenerationProblem -> NSGA-II on the card -> minimize ->
Pareto-front decision -> render; then `evolve.batched.make_batched` /
`minimize_batched` for several targets over the same weights. Random
weights (`random:<seed>`) let it run without checkpoints.

Run:
  python examples/api_search_torch.py --tiny --device cpu   # seconds on the CPU
  python examples/api_search_torch.py                       # full width on the card
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true",
                    help="tiny random-weight models (seconds on the CPU)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default="./tmp_api_example_torch")
    args = ap.parse_args()

    import numpy as np
    import torch

    from clip_glass_torch.config import get_config
    from clip_glass_torch.evolve.algorithm import minimize
    from clip_glass_torch.evolve.batched import make_batched, minimize_batched
    from clip_glass_torch.evolve.decision import pick
    from clip_glass_torch.evolve.nds import non_dominated_rank
    from clip_glass_torch.fitness.problem import GenerationProblem

    # 1. configure (the config registry; overrides via replace)
    config = get_config("StyleGAN2_ffhq_d").replace(
        target="the face of a man with brown eyes", weights="random:0", pop_size=8)
    clip_cfg = model_cfg = None
    if args.tiny:
        from clip_glass_torch.cli import _tinyfy
        config, clip_cfg, model_cfg = _tinyfy(config)

    # 2. the fitness problem (CLIP + G + D on the device) and its NSGA-II
    problem = GenerationProblem(config, device=args.device, clip_cfg=clip_cfg,
                                model_cfg=model_cfg)
    algorithm = problem.make_algorithm()

    # 3. search: every draw comes from one seeded torch.Generator
    res = minimize(algorithm, n_gen=8, generator=0, save_each=4, verbose=True)
    print(f"final population F {tuple(res.pop_F.shape)}: "
          f"best similarity {-res.pop_F[:, 0].min().item():.4f}")  # F0 = -cosine

    # 4. decision on the rank-0 front (reference run.py:103-113) and render
    os.makedirs(args.out, exist_ok=True)

    def save_best(r, name):
        front = (non_dominated_rank(r.pop_F) == 0).numpy()
        X_opt, F_opt = r.pop_X.numpy()[front], r.pop_F.numpy()[front]
        X_best = np.atleast_2d(X_opt[pick(F_opt, (0, 1))])
        path = os.path.join(args.out, name)
        rendered = problem.generator.render(torch.from_numpy(X_best).to(problem.device))
        problem.generator.save(rendered, path)
        print(f"wrote {path}")

    save_best(res, "best.jpg")

    # 5. several targets over the same weights: one evaluation per
    #    generation for all of them; search i searches as an independent
    #    run seeded evolve.batched.search_generator(0, i)
    prompts = ["a red flower", "a blue car"]
    for i, r in enumerate(minimize_batched(make_batched(problem, prompts), n_gen=4,
                                           generators=0, save_each=4, verbose=True)):
        save_best(r, f"search-{i:02d}.jpg")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
