#!/usr/bin/env python3
"""The port's serving curve: useful candidates/s against request length.

The counterpart of scripts/bench_serving_curve.py. For each length L in CURVE_GENS the same
churn (R requests through K slots) runs CURVE_REPEATS times; each point
gives the median, min and max useful rate, and their share of the ceiling
and of the steady state.

Both are measured in the same run on the same card, on the server's own
slots' work (K searches batched, evolve/batched.py), after one warm-up
generation, each the fastest of CURVE_REPEATS windows:
- a generation of all K slots: windows of the longest L generations;
  `steady` = K x pop over its seconds;
- an admission of K requests, as the server admits them: the targets
  encoded, K populations sampled and evaluated in one call.
Each request of L generations also pays its admission, which is cheaper
than a generation (no variation, no survival), so at full occupancy the
useful rate can reach at most the ceiling K x pop x L / (admission + L x
generation) seconds. The script exits 1, after its JSON line, when a point's
median is above its ceiling: the steady state was then measured too slow.

Variables: those of scripts/bench_serving_torch.py (SERVE_CONFIG,
SERVE_SLOTS, SERVE_CHUNK, SERVE_REQUESTS, SERVE_POP, SERVE_QUANT,
SERVE_SEARCH_MB), CURVE_GENS (20,40,100) and CURVE_REPEATS (3).

  python3 scripts/bench_serving_curve_torch.py [--device cuda] [--tiny]
"""

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bench_serving_torch import make_server, parse_args, settings, stream, sync  # noqa: E402


def slot_costs(server, dev, gens: int, repeats: int):
    """(seconds a generation, seconds an admission) of the server's K
    slots, all occupied: each the fastest of `repeats` windows (a window of
    `gens` generations, or one admission) after one warm-up generation."""
    import torch

    from clip_glass_torch.evolve.batched import make_batched, search_generator

    K = server.n_slots
    balgo = make_batched(server.problem, [f"steady state, variant {i}" for i in range(K)],
                         search_microbatch=server.balgo.search_microbatch)
    gen_s, admit_s = [], []
    with torch.inference_mode():
        generators = balgo.generators(1)
        state = balgo.step(balgo.init(generators), generators)
        for rep in range(repeats):
            sync(dev)
            t0 = time.perf_counter()
            for _ in range(gens):
                state = balgo.step(state, generators)
            sync(dev)
            gen_s.append((time.perf_counter() - t0) / gens)
            t0 = time.perf_counter()
            feats = server.problem.generator.encode_targets(
                [f"admission {rep}, variant {i}" for i in range(K)])
            X0 = torch.stack([balgo.sample(search_generator(2 + rep, i, balgo.device))
                              for i in range(K)])
            balgo.evaluate(X0, feats)
            sync(dev)
            admit_s.append(time.perf_counter() - t0)
    return min(gen_s), min(admit_s)


def curve_point(n_gen: int, rates, slots: int, pop: int, gen_s: float, admit_s: float) -> dict:
    """One point of the curve: the useful rates of its repeats against the
    ceiling of requests of `n_gen` generations and the steady state."""
    med = statistics.median(rates)
    steady = slots * pop / gen_s
    ceiling = slots * pop * n_gen / (admit_s + n_gen * gen_s)
    return {"gens_per_request": n_gen, "repeats": len(rates), "median_useful_cand_s": med,
            "min": min(rates), "max": max(rates), "rates": list(rates),
            "ceiling_adjusted": ceiling, "pct_of_adjusted_ceiling": 100 * med / ceiling,
            "pct_of_steady": 100 * med / steady}


def main(argv=None) -> int:
    args = parse_args(argv, __doc__)
    s = settings()
    env = os.environ
    lengths = [int(g) for g in env.get("CURVE_GENS", "20,40,100").split(",")]
    repeats = int(env.get("CURVE_REPEATS", "3"))
    server, dev, kind = make_server(s, args.device, args.tiny)
    gen_s, admit_s = slot_costs(server, dev, max(lengths), repeats)
    points = []
    for n_gen in lengths:
        rates = []
        for rep in range(repeats):
            dt, st = stream(server, dev, s["requests"], n_gen, f"length {n_gen} rep {rep}")
            rates.append(st.useful_evals / dt)
            print(f"  gens={n_gen} rep={rep}: {rates[-1]:.1f} useful cand/s (occupancy "
                  f"{st.occupancy:.3f}, wall {dt:.2f} s)", file=sys.stderr, flush=True)
        points.append(curve_point(n_gen, rates, s["slots"], s["pop"], gen_s, admit_s))
    over = [p["gens_per_request"] for p in points if p["pct_of_adjusted_ceiling"] > 100]
    out = {
        "metric": (f"serving convergence curve ({s['name']}, pop={s['pop']}, {s['slots']} "
                   f"slots x chunk {s['chunk']}, {s['requests']} requests per point"
                   f"{', TINY' if args.tiny else ''})"),
        "steady_state_cand_s": s["slots"] * s["pop"] / gen_s,
        "generation_s": gen_s,
        "admission_s": admit_s,
        "steady_state_source": (f"measured: {s['slots']} searches batched, the fastest of "
                                f"{repeats} windows of {max(lengths)} generations"),
        "points": points,
        "above_ceiling": over,
        "device_kind": kind,
    }
    print(json.dumps(out))
    if over:
        print(f"points above their ceiling: {over} generations a request", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
