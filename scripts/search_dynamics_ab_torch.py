#!/usr/bin/env python3
"""Search-dynamics A/B of the PyTorch/CUDA port: its engine against a host
pymoo-0.4.2-style loop, and against itself with fresh noise each evaluation.

The port's GA / NSGA-II (evolve/algorithm.py) departs from the reference's
pymoo loop (reference run.py:59-76) in two documented ways:
  1. duplicate offspring are RESAMPLED from the init distribution instead of
     pymoo's re-mate-until-full retry loop;
  2. StyleGAN2's noise planes are drawn once per search instead of at every
     evaluation (the reference redraws them).
This script measures whether those change how a search proceeds: for each
config, N seeded searches of each of three loops on TINY models (pop 8,
n_var 32, fp32, every layer's noise_scale 0.3 so that the noise matters),
the best F0 after each generation, as mean +/- sd over the seeds, with the
per-generation Welch z of each loop against the engine:
  - device: the port's engine (`Algorithm.init` / `step_fn`, a
    torch.Generator seeded s);
  - host: a pymoo-0.4.2-style loop on the host from the transcribed
    operators (tests/pymoo_oracle.py: tournaments, SBX / PM, FitnessSurvival
    / RankAndCrowdingSurvival, the re-mate dedup), fed the same fitness;
  - fresh-noise: the engine with new noise planes at each evaluation, drawn
    from the evaluation's own seed (`algorithm.draw_seed`, the seed a
    stochastic fitness gets).

Usage: python scripts/search_dynamics_ab_torch.py [--seeds 8] [--gens 30]
       [--device cuda|cpu]
Writes a markdown table to stdout; the JAX package's counterpart is
scripts/search_dynamics_ab.py.
"""

from __future__ import annotations

import argparse
import math
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(1, os.path.join(REPO, "tests"))   # pymoo_oracle (numpy only)

import numpy as np  # noqa: E402
import torch  # noqa: E402

CONFIGS = (("StyleGAN2_ffhq_nod", False), ("StyleGAN2_ffhq_d", True))
NOISE_SCALE = 0.3


def host_minimize(eval_np, config, seed, n_gen, use_nsga2):
    """pymoo-0.4.2-style host loop from the transcribed oracles: tournament
    selection (random permutation pairs), SBX + PM, re-mate duplicate
    elimination (pymoo Mating.do retry, up to 100 iterations), (mu+lambda)
    FitnessSurvival or RankAndCrowdingSurvival. The best F0 after the
    initial population and after each generation."""
    import pymoo_oracle as po

    rng = np.random.default_rng(seed)
    pop_size = config.pop_size
    n_var = config.n_var
    xl, xu = config.xl, config.xu

    X = rng.standard_normal((pop_size, n_var))  # NormalRandomSampling
    F = eval_np(X)
    if use_nsga2:
        _, rank, crowd = po.rank_and_crowding_survival(F, pop_size)
    best = [F[:, 0].min()]

    def pairs_from_perms(n_pick):
        n_random = n_pick * 2
        n_perms = math.ceil(n_random / pop_size)
        perm = np.concatenate([rng.permutation(pop_size)
                               for _ in range(n_perms)])[:n_random]
        return perm.reshape(n_pick, 2)

    def mate(n_off):
        off = np.empty((0, n_var))
        for _ in range(100):  # pymoo Mating.do retry loop
            need = n_off - len(off)
            if need <= 0:
                break
            n_mat = math.ceil(need / 2)
            P = pairs_from_perms(n_mat)
            tie = rng.random(n_mat) < 0.5
            if use_nsga2:
                S = po.tournament_nsga2(F, crowd, P, tie)
                P2 = pairs_from_perms(n_mat)
                S2 = po.tournament_nsga2(F, crowd, P2, rng.random(n_mat) < 0.5)
            else:
                S = po.tournament_ga(F, P, tie)
                P2 = pairs_from_perms(n_mat)
                S2 = po.tournament_ga(F, P2, rng.random(n_mat) < 0.5)
            x1, x2 = X[S], X[S2]
            m = len(x1)
            o1, o2 = po.sbx(x1, x2, xl, xu, 3.0, 1.0, 0.5,
                            rng.random((m, 1)), rng.random((m, n_var)),
                            rng.random((m, n_var)), rng.random((m, n_var)))
            cand = np.concatenate([o1, o2])[:need]
            cand = po.polynomial_mutation(cand, xl, xu, 3.0, 0.5,
                                          rng.random(cand.shape), rng.random(cand.shape))
            # DefaultDuplicateElimination vs current pop + accepted offspring
            ref = np.concatenate([X, off])
            keep = []
            for i, c in enumerate(cand):
                pool = np.concatenate([ref, cand[:i]])
                if not np.any(np.all(np.abs(pool - c) <= 1e-16, axis=1)):
                    keep.append(i)
            off = np.concatenate([off, cand[keep]])
        return off[:n_off]

    for _ in range(n_gen):
        off = mate(pop_size)
        F_off = eval_np(off)
        X_all = np.concatenate([X, off])
        F_all = np.concatenate([F, F_off])
        if use_nsga2:
            I, _, _ = po.rank_and_crowding_survival(F_all, pop_size)
            X, F = X_all[I], F_all[I]
            _, rank, crowd = po.rank_and_crowding_survival(F, pop_size)
        else:
            I = po.fitness_survival(F_all, pop_size)
            X, F = X_all[I], F_all[I]
        best.append(F[:, 0].min())
    return np.asarray(best)


def engine_curve(algo, seed: int, gens: int) -> list:
    """The best F0 of the port's engine after init and each generation."""
    gen = algo.generator(seed)
    state = algo.init(gen)
    best = [float(state.F[:, 0].min())]
    step = algo.step_fn()
    with torch.inference_mode():
        for _ in range(gens):
            state = step(state, gen)
            best.append(float(state.F[:, 0].min()))
    return best


def make_problem(name: str, device):
    """The config's TINY problem (pop 8, n_var 32, fp32, random weights from
    seed 0) with every layer's noise_scale set to NOISE_SCALE (the random
    init's 0 injects no noise; trained checkpoints learn it)."""
    from clip_glass_torch.config import get_config
    from clip_glass_torch.fitness.problem import GenerationProblem
    from clip_glass_torch.models.clip import model as clip_model
    from clip_glass_torch.models.stylegan2 import model as sg2

    config = get_config(name).replace(target="a red flower", weights="random:0", pop_size=8,
                                      dim_z=32, n_var=32, compute_dtype="float32")
    problem = GenerationProblem(config, device=device, clip_cfg=clip_model.TINY,
                                model_cfg=sg2.TINY)
    for block in problem.generator.g_params["synthesis"]["blocks"]:
        for layer in block["layers"]:
            if "noise_scale" in layer:
                layer["noise_scale"] = torch.full_like(layer["noise_scale"], NOISE_SCALE)
    return problem


def fresh_noise_algorithm(problem):
    """The engine whose evaluation draws new noise planes from its own seed
    (handed over as a stochastic fitness's is)."""
    from clip_glass_torch.evolve.algorithm import Algorithm
    from clip_glass_torch.models.stylegan2 import model as sg2

    gen = problem.generator
    base = problem.make_algorithm()

    def eval_fresh(X, seed):
        g = torch.Generator(device=X.device).manual_seed(seed)
        planes = [torch.randn(s, generator=g, device=X.device)
                  for s in gen.model_cfg.noise_shapes()]
        noise = sg2.pack_noise([gen.policy.cast_compute(p) for p in planes], gen.model_cfg,
                               gen.policy)
        return gen.eval_population(X, {**gen.bundle, "noise": noise})

    return Algorithm(ops=base.ops, eval_fn=eval_fresh, pop_size=base.pop_size,
                     algorithm=base.algorithm, device=base.device, stochastic=True)


def welch_z(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|mean a - mean b| / sqrt(var a / n + var b / n) per generation (the
    rows of a and b: one seed each)."""
    n = a.shape[0]
    return np.abs(a.mean(0) - b.mean(0)) / np.sqrt(
        a.std(0, ddof=1) ** 2 / n + b.std(0, ddof=1) ** 2 / n + 1e-12)


def run(seeds: int, gens: int, device="cuda") -> list:
    """Per config: {name, curves {device, host, fresh-noise}: [seeds, gens +
    1] best F0, z (host vs device), zf (fresh-noise vs device)}."""
    from clip_glass_torch.core.device import resolve_device

    device = resolve_device(device)
    rows = []
    for name, use_nsga2 in CONFIGS:
        problem = make_problem(name, device)
        gen = problem.generator

        def eval_np(X):
            with torch.inference_mode():
                F = gen.eval_population(torch.as_tensor(X, dtype=torch.float32, device=device))
            return F.double().cpu().numpy()

        algo, algo_f = problem.make_algorithm(), fresh_noise_algorithm(problem)
        curves = {"device": [], "host": [], "fresh-noise": []}
        for s in range(seeds):
            curves["device"].append(engine_curve(algo, s, gens))
            curves["host"].append(host_minimize(eval_np, problem.config, seed=s, n_gen=gens,
                                                use_nsga2=use_nsga2))
            curves["fresh-noise"].append(engine_curve(algo_f, s, gens))
        C = {k: np.asarray(v, np.float64) for k, v in curves.items()}
        rows.append({"name": name, "curves": C, "z": welch_z(C["device"], C["host"]),
                     "zf": welch_z(C["device"], C["fresh-noise"])})
    return rows


def table(rows: list, seeds: int, gens: int) -> str:
    lines = [f"\n## Search-dynamics A/B ({seeds} seeds, {gens} generations, "
             f"TINY models, pop 8)\n",
             "| config | gen | device best F0 (mean+/-sd) | host-pymoo "
             "(mean+/-sd) | Welch z | fresh-noise (mean+/-sd) | z vs device |",
             "|---|---|---|---|---|---|---|"]
    for r in rows:
        C = r["curves"]
        md, sd = C["device"].mean(0), C["device"].std(0, ddof=1)
        mh, sh = C["host"].mean(0), C["host"].std(0, ddof=1)
        mf, sf = C["fresh-noise"].mean(0), C["fresh-noise"].std(0, ddof=1)
        z, zf = r["z"], r["zf"]
        for g in sorted({0, gens // 4, gens // 2, gens}):
            lines.append(f"| {r['name']} | {g} | {md[g]:+.4f}+/-{sd[g]:.4f} "
                         f"| {mh[g]:+.4f}+/-{sh[g]:.4f} | {z[g]:.2f} "
                         f"| {mf[g]:+.4f}+/-{sf[g]:.4f} | {zf[g]:.2f} |")
        lines.append(f"| {r['name']} | max-z over all gens |  |  | {z.max():.2f} |  "
                     f"| {zf.max():.2f} |")
    lines.append("\nWelch z < ~2 => statistically indistinguishable at the "
                 "per-generation level for this seed count.")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--gens", type=int, default=30)
    ap.add_argument("--device", default="cuda",
                    help="where the engine and the fitness run (default: the card)")
    a = ap.parse_args(argv)
    if a.seeds < 2:
        ap.error("--seeds must be at least 2 (a standard deviation per generation)")
    print(table(run(a.seeds, a.gens, a.device), a.seeds, a.gens))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
