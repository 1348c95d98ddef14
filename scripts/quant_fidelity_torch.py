#!/usr/bin/env python
"""Fitness fidelity of the port's int8 quantized mode (clip_glass_torch/ops/
quant.py) against its exact (bf16) fitness, and the int8 promotion gate:
the port's counterpart of scripts/quant_fidelity.py, with the same
measurements, the same GATE thresholds (DESIGN.md §10) and the same JSON
verdict. It imports only the port.

Evaluates the SAME populations under the exact and the int8 fitness and
reports, per objective: max / mean absolute difference, Spearman rank
correlation per population (the GA reads fitness only through comparisons),
top-k overlap (k = pop/2, the survival cut), and for NSGA-II configs the
overlap of the (mu+lambda) survival selection that the two fitness
versions induce on a parent + offspring pool.

Usage (the card by default; --device cpu runs on the host):
  python scripts/quant_fidelity_torch.py [--config StyleGAN2_ffhq_d] [--pops 4]
                                         [--pop-size 16] [--weights random:0]

Promotion gate: `--gate` runs all four criteria and prints ONE JSON verdict
line on stdout (progress on stderr): PASS/FAIL per criterion against GATE,
or BLOCKED on random weights (the criteria depend on the weights'
distribution; each BLOCKED criterion still reports its measured value and
what it would decide):

  python scripts/quant_fidelity_torch.py --gate --weights path/to/ckpt \\
      [--gate-seeds 5] [--generations 200]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the promotion gate's thresholds (DESIGN.md §10, scripts/quant_fidelity.py)
GATE = {
    "rank_spearman_min": 0.90,       # criterion 1, min over >=4 pops
    "topk_overlap_min": 0.85,        # criterion 2 (survival cut, top pop/2)
    "survival_overlap_min": 0.85,    # criterion 2 (NSGA-II mu+lambda)
    "ab_min_seeds": 5,               # criterion 3, seeds x 200 generations
    "ab_seed_spread_factor": 1.5,    # criterion 3, worst single seed
    "saturation_ratio_max": 1.0,     # criterion 4, fresh absmax / scale
}


def spearman(a, b):
    import numpy as np
    ra = np.argsort(np.argsort(a)).astype(np.float64)
    rb = np.argsort(np.argsort(b)).astype(np.float64)
    ra -= ra.mean()
    rb -= rb.mean()
    den = np.sqrt((ra * ra).sum() * (rb * rb).sum())
    return float((ra * rb).sum() / den) if den else 1.0


# --------------------------------------------------------------- collectors
#
# Each collector measures one gate input and returns plain floats and lists;
# `gate_verdict` is a pure function of those.

def _problems(cfg, pb_kwargs):
    from clip_glass_torch.fitness.problem import GenerationProblem

    kw = pb_kwargs or {}
    return (GenerationProblem(cfg, **kw),
            GenerationProblem(cfg.replace(quantize="int8"), **kw))


def collect_fidelity(cfg, pops, pb_kwargs=None, log=print):
    """Criteria 1-2 inputs: per-population Spearman / top-k overlap of every
    objective under exact vs int8 fitness, plus the NSGA-II (mu+lambda)
    survival overlap for two-objective configs."""
    import numpy as np
    import torch

    from clip_glass_torch.evolve.algorithm import operators_for_config
    from clip_glass_torch.evolve.survival import nsga2_survival

    pb_f, pb_q = _problems(cfg, pb_kwargs)
    sample = operators_for_config(cfg).sample
    gen = torch.Generator(device=pb_f.device).manual_seed(42)
    Fs, Qs = [], []
    for i in range(pops):
        X = sample(gen, cfg.pop_size)
        Fs.append(pb_f.generator.eval_population(X).cpu().numpy())
        Qs.append(pb_q.generator.eval_population(X).cpu().numpy())
        log(f"  fidelity pop {i + 1}/{pops} evaluated")
    F, Q = np.concatenate(Fs), np.concatenate(Qs)   # [pops*pop, n_obj]

    n_obj = F.shape[1]
    k = cfg.pop_size // 2
    objectives = []
    for j in range(n_obj):
        d = np.abs(F[:, j] - Q[:, j])
        objectives.append({
            "max_abs_d": float(d.max()),
            "mean_abs_d": float(d.mean()),
            "spearman_per_pop": [spearman(f[:, j], q[:, j]) for f, q in zip(Fs, Qs)],
            "topk_per_pop": [
                len(set(np.argsort(f[:, j])[:k]) & set(np.argsort(q[:, j])[:k])) / k
                for f, q in zip(Fs, Qs)],
        })

    survival = None
    if n_obj == 2:
        # which of the 2*pop pool members rank + crowding keeps under each
        # fitness version (X = pool indices)
        survival = []
        for f, q in zip(Fs, Qs):
            n = f.shape[0]
            idx = torch.arange(2 * n, dtype=torch.float64)[:, None]
            kept = [set(nsga2_survival(idx, torch.from_numpy(
                        np.concatenate([v, v + 0.01 * np.abs(v) + 1e-4])), n)[0]
                        .ravel().long().tolist()) for v in (f, q)]
            survival.append(len(kept[0] & kept[1]) / n)

    return {"pops": pops, "pop_size": cfg.pop_size, "k": k, "n_obj": n_obj,
            "objectives": objectives, "survival_overlap_per_pop": survival}


def collect_ab(cfg, seeds, n_gen, pb_kwargs=None, log=print):
    """Criterion 3 input: full searches under exact vs int8 fitness, one per
    seed; each run's best final F[:, 0] (the minimized -similarity)."""
    from clip_glass_torch.evolve.algorithm import minimize

    log(f"search-outcome A/B: {cfg.name} pop {cfg.pop_size}, "
        f"{n_gen} generations x {len(seeds)} seeds")
    best = {"bf16": [], "int8": []}
    for mode, pb in zip(("bf16", "int8"), _problems(cfg, pb_kwargs)):
        algo = pb.make_algorithm()
        for seed in seeds:
            res = minimize(algo, n_gen, seed, save_each=n_gen)
            b = float(res.pop_F[:, 0].min())
            best[mode].append(b)
            log(f"  {mode} seed {seed}: best sim {-b:.4f}")
    return best


def collect_saturation(cfg, pb_kwargs=None, fresh_seed=20260819, log=print):
    """Criterion 4 input: each eligible conv's input absmax on a FRESH
    population (a seed the calibration never saw) against the calibrated
    scales (margin included); max_ratio <= 1: no site saturates."""
    import numpy as np
    import torch

    from clip_glass_torch.evolve.algorithm import operators_for_config
    from clip_glass_torch.fitness.problem import GenerationProblem
    from clip_glass_torch.ops import quant

    pb_q = GenerationProblem(cfg.replace(quantize="int8"), **(pb_kwargs or {}))
    gen = pb_q.generator
    scales = gen._quant_scales
    if scales is None:
        log("  saturation: no eligible conv call sites (structural no-op)")
        return {"eligible_sites": 0, "max_ratio": 0.0, "mean_ratio": 0.0}
    rng = torch.Generator(device=pb_q.device).manual_seed(fresh_seed)
    X = operators_for_config(cfg).sample(rng, cfg.eval_microbatch or cfg.pop_size)
    with torch.inference_mode(), quant.calibration(cfg.quantize_min_ch) as records:
        gen._eval_batch_raw(X, gen.bundle)
    fresh = torch.stack(records).double().cpu().numpy()
    base = np.asarray(scales, np.float64)
    # scale 0 marks a dead site that runs in float: it cannot saturate
    ratios = np.where(base > 0, fresh / np.maximum(base, 1e-30), 0.0)
    log(f"  saturation: {len(base)} call sites, fresh/scale max "
        f"{ratios.max():.4f} mean {ratios.mean():.4f}")
    return {"eligible_sites": int(len(base)), "max_ratio": float(ratios.max()),
            "mean_ratio": float(ratios.mean())}


# ------------------------------------------------------------ gate verdict

def gate_verdict(meas, pretrained):
    """The gate's threshold logic, a pure function: measurements -> verdict.

    pretrained=False (random weights) marks every criterion BLOCKED (random
    weights cannot decide promotion), each still carrying its measured
    value and what it would decide."""
    import numpy as np

    t = GATE
    crits = []

    def crit(name, measured, threshold, ok, detail=""):
        c = {"criterion": name, "measured": measured, "threshold": threshold,
             "would": "PASS" if ok else "FAIL",
             "status": ("PASS" if ok else "FAIL") if pretrained else "BLOCKED"}
        if not pretrained:
            c["note"] = ("pretrained checkpoint required — criteria are "
                         "distribution-sensitive (DESIGN.md §10)")
        if detail:
            c["detail"] = detail
        crits.append(c)

    # 1. rank fidelity: similarity-objective Spearman >= 0.90 PER population
    sp = meas["fidelity"]["objectives"][0]["spearman_per_pop"]
    v = float(min(sp))
    detail = f"min over {len(sp)} pops (mean {float(np.mean(sp)):.4f})"
    ok = v >= t["rank_spearman_min"]
    if len(sp) < 4:
        ok = False
        detail += "; gate requires >= 4 independent pops"
    crit("rank_fidelity", round(v, 4), t["rank_spearman_min"], ok, detail)

    # 2. selection fidelity: survival-cut overlap, + NSGA-II mu+lambda
    topk = float(np.mean(meas["fidelity"]["objectives"][0]["topk_per_pop"]))
    surv = meas["fidelity"]["survival_overlap_per_pop"]
    measured = {"topk_overlap": round(topk, 4)}
    threshold = {"topk_overlap": t["topk_overlap_min"]}
    ok = topk >= t["topk_overlap_min"]
    if surv is not None:
        sv = float(np.mean(surv))
        measured["survival_overlap"] = round(sv, 4)
        threshold["survival_overlap"] = t["survival_overlap_min"]
        ok = ok and sv >= t["survival_overlap_min"]
    crit("selection_fidelity", measured, threshold, ok,
         f"top-{meas['fidelity']['k']} cut"
         + ("" if surv is None else " + NSGA-II (mu+lambda) survival"))

    # 3. outcome A/B: mean delta within the bf16 seed spread; worst seed
    #    within 1.5x of it
    b = np.asarray(meas["ab"]["bf16"], np.float64)  # best F (minimized -sim)
    q = np.asarray(meas["ab"]["int8"], np.float64)
    spread = float(b.max() - b.min())
    delta_sim = b - q  # positive = int8 converged to a BETTER similarity
    worst = float(np.maximum(0.0, -delta_sim).max())
    mean_d = float(delta_sim.mean())
    ok = abs(mean_d) <= spread and worst <= t["ab_seed_spread_factor"] * spread
    detail = f"{len(b)} seeds"
    if len(b) < t["ab_min_seeds"]:
        ok = False
        detail += f"; gate requires >= {t['ab_min_seeds']} seeds"
    crit("outcome_ab",
         {"mean_delta_sim": round(mean_d, 5),
          "worst_seed_regression": round(worst, 5),
          "bf16_seed_spread": round(spread, 5)},
         {"abs_mean_delta_max": round(spread, 5),
          "worst_regression_max": round(t["ab_seed_spread_factor"] * spread, 5)},
         ok, detail)

    # 4. calibration stability: no eligible conv saturates on a fresh pop
    sat = meas["saturation"]
    if sat["eligible_sites"] == 0:
        crit("calibration_saturation", 0.0, t["saturation_ratio_max"], True,
             "no eligible conv call sites — int8 is a structural no-op "
             "for this config")
    else:
        crit("calibration_saturation", round(sat["max_ratio"], 4),
             t["saturation_ratio_max"], sat["max_ratio"] <= t["saturation_ratio_max"],
             f"{sat['eligible_sites']} call sites, fresh-population "
             f"absmax / calibrated scale")

    overall = ("BLOCKED" if not pretrained
               else "PASS" if all(c["status"] == "PASS" for c in crits)
               else "FAIL")
    return {"gate": "int8-promotion", "pretrained": pretrained,
            "overall": overall, "criteria": crits}


def run_gate(cfg, args, pb_kwargs=None, log=None):
    """Collect the four measurements and print ONE JSON verdict line."""
    if log is None:
        def log(*a, **k):
            print(*a, file=sys.stderr, **k)
    pretrained = not str(cfg.weights).startswith("random")
    log(f"int8 promotion gate: config={cfg.name} weights={cfg.weights} "
        f"pretrained={pretrained}")
    meas = {
        "fidelity": collect_fidelity(cfg, args.pops, pb_kwargs, log=log),
        "ab": collect_ab(cfg, list(range(args.gate_seeds)), args.generations,
                         pb_kwargs, log=log),
        "saturation": collect_saturation(cfg, pb_kwargs, log=log),
    }
    verdict = gate_verdict(meas, pretrained)
    verdict["config"] = cfg.name
    verdict["weights"] = str(cfg.weights)
    print(json.dumps(verdict))
    return verdict


# ----------------------------------------------------------------- reports

def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="StyleGAN2_ffhq_d")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--pops", type=int, default=4,
                    help="number of independent populations to evaluate")
    ap.add_argument("--pop-size", type=int, default=16)
    ap.add_argument("--weights", default="random:0")
    ap.add_argument("--min-ch", type=int, default=None, help="override quantize_min_ch")
    ap.add_argument("--search-ab", type=int, default=0, metavar="N_SEEDS",
                    help="instead of value/rank fidelity, run full-search "
                         "outcome A/Bs over this many seeds")
    ap.add_argument("--generations", type=int, default=200)
    ap.add_argument("--gate", action="store_true",
                    help="run the four promotion criteria and print one JSON verdict "
                         "line (PASS/FAIL per criterion; BLOCKED on random weights)")
    ap.add_argument("--gate-seeds", type=int, default=5,
                    help="A/B seeds for the --gate outcome criterion")
    args = ap.parse_args()

    import numpy as np

    from clip_glass_torch.config import get_config

    cfg = get_config(args.config).replace(
        target="the face of a man with brown eyes", weights=args.weights,
        pop_size=args.pop_size, compute_dtype="bfloat16")
    if args.min_ch is not None:
        cfg = cfg.replace(quantize_min_ch=args.min_ch)
    pb_kwargs = {"device": args.device}
    if args.gate:
        return run_gate(cfg, args, pb_kwargs)
    if args.search_ab:
        best = collect_ab(cfg, list(range(args.search_ab)), args.generations, pb_kwargs)
        db = np.asarray(best["int8"]) - np.asarray(best["bf16"])
        print(f"  best-sim delta int8-vs-bf16 per seed (positive = int8 "
              f"better): {np.array2string(-db, precision=4)}")
        return None

    fid = collect_fidelity(cfg, args.pops, pb_kwargs, log=lambda *a, **k: None)
    print(f"config={cfg.name} pop_size={cfg.pop_size} pops={args.pops} "
          f"min_ch={cfg.quantize_min_ch} margin={cfg.quantize_margin}")
    for j, nm in enumerate(["-cosine_sim", "D_hinge"][:fid["n_obj"]]):
        o = fid["objectives"][j]
        print(f"  obj[{j}] {nm:12s}: max|d|={o['max_abs_d']:.5f} "
              f"mean|d|={o['mean_abs_d']:.5f} "
              f"spearman={float(np.mean(o['spearman_per_pop'])):.4f} "
              f"top-{fid['k']} overlap={float(np.mean(o['topk_per_pop'])):.3f}")
    if fid["survival_overlap_per_pop"] is not None:
        print(f"  NSGA-II survival selection overlap: "
              f"{float(np.mean(fid['survival_overlap_per_pop'])):.3f}")
    return None


if __name__ == "__main__":
    main()
