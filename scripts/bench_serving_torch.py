#!/usr/bin/env python3
"""The port's continuous-batching server (clip_glass_torch/serving.py) under
churn: R requests streamed through K resident slots, useful candidates/s
(occupied slots' generations), raw candidates/s (idle slots' work
included) and the occupancy. The counterpart of scripts/bench_serving.py,
with its variables:

  SERVE_CONFIG (StyleGAN2_ffhq_d)  SERVE_SLOTS (8)  SERVE_CHUNK (10)
  SERVE_REQUESTS (3 x slots)  SERVE_GENS (2 x chunk)  SERVE_POP (16)
  SERVE_QUANT ("int8")  SERVE_SEARCH_MB

Warm-up: one request a slot for one chunk. Then the timed stream, fenced by
`torch.cuda.synchronize()`. Prints one JSON line.

  python3 scripts/bench_serving_torch.py [--device cuda] [--tiny]
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from bench_torch import TEXT_TARGET  # noqa: E402


def parse_args(argv, doc: str):
    p = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    p.add_argument("--tiny", action="store_true",
                   help="the TINY models (a smoke run of the protocol, not a measurement)")
    return p.parse_args(argv)


def settings() -> dict:
    env = os.environ
    slots = int(env.get("SERVE_SLOTS", "8"))
    chunk = int(env.get("SERVE_CHUNK", "10"))
    return {"name": env.get("SERVE_CONFIG", "StyleGAN2_ffhq_d"), "slots": slots,
            "chunk": chunk, "requests": int(env.get("SERVE_REQUESTS", str(3 * slots))),
            "gens": int(env.get("SERVE_GENS", str(2 * chunk))),
            "pop": int(env.get("SERVE_POP", "16")), "quant": env.get("SERVE_QUANT", ""),
            "search_mb": int(env["SERVE_SEARCH_MB"]) if env.get("SERVE_SEARCH_MB") else None}


def make_server(s: dict, device: str, tiny: bool):
    """The server of `settings()` after its warm-up, and the card's name."""
    from clip_glass_torch.config import get_config
    from clip_glass_torch.core.device import resolve_device
    from clip_glass_torch.fitness.problem import GenerationProblem
    from clip_glass_torch.models.clip import model as clip_model
    from clip_glass_torch.models.stylegan2 import model as sg2
    from clip_glass_torch.serving import SearchServer

    dev = resolve_device(device)
    config = get_config(s["name"]).replace(target=TEXT_TARGET, weights="random:0",
                                           pop_size=s["pop"], compute_dtype="bfloat16")
    if s["quant"]:
        config = config.replace(quantize=s["quant"])
    models = {}
    if tiny:
        if config.model != "stylegan2":
            raise SystemExit("--tiny: StyleGAN2 configs only")
        config = config.replace(dim_z=32, n_var=32)
        models = {"clip_cfg": clip_model.TINY, "model_cfg": sg2.TINY}
    problem = GenerationProblem(config, device=dev, **models)
    server = SearchServer(problem, n_slots=s["slots"], chunk=s["chunk"], seed=0,
                          search_microbatch=s["search_mb"])
    for i in range(s["slots"]):
        server.submit(f"warmup prompt {i}", n_gen=s["chunk"])
    server.run()
    sync(dev)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return server, dev, kind


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def stream(server, dev, n_req: int, n_gen: int, label: str):
    """Submit n_req requests of n_gen generations, run them to the end;
    returns (seconds, the stats of this stream)."""
    from clip_glass_torch.serving import ServerStats

    server.stats = ServerStats()
    sync(dev)
    t0 = time.perf_counter()
    for i in range(n_req):
        server.submit(f"a portrait, {label} variant {i}", n_gen=n_gen)
    server.run()
    sync(dev)
    return time.perf_counter() - t0, server.stats


def main(argv=None) -> int:
    args = parse_args(argv, __doc__)
    s = settings()
    server, dev, kind = make_server(s, args.device, args.tiny)
    dt, st = stream(server, dev, s["requests"], s["gens"], "served")
    n_cards = 1
    out = {
        "metric": (f"served_candidates_per_sec_per_chip ({s['name']}, pop={s['pop']}, "
                   f"{s['slots']} slots x chunk {s['chunk']}, {s['requests']} requests x "
                   f"{s['gens']} gens streamed{', ' + s['quant'] if s['quant'] else ''}"
                   f"{', TINY' if args.tiny else ''})"),
        "value": st.useful_evals / dt / n_cards,
        "unit": "candidates/s/chip",
        "raw_incl_padding": st.total_evals / dt / n_cards,
        # each admitted request also scores its initial population, which the
        # steady-state rates leave out
        "incl_admission_evals": (st.useful_evals + st.admission_evals) / dt / n_cards,
        "occupancy": st.occupancy,
        "completed": st.completed,
        "dispatches": st.ticks,
        "wall_s": dt,
        "device_kind": kind,
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
