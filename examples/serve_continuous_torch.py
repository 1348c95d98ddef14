#!/usr/bin/env python
"""Continuous-batching serving on the PyTorch/CUDA port: requests arrive
over time, the slots stay resident (`clip_glass_torch.serving.SearchServer`).

`serve_batched_torch.py` shows K prompts known up front. Here a fixed
number of slots advance together, a client thread submits requests while
the server ticks, and each finished slot is harvested and refilled with the
next queued request. The request with ticket t searches as an independent
run seeded `search_generator(seed, t)` (tests/test_torch_serving.py).

  python examples/serve_continuous_torch.py --tiny --device cpu --slots 2
  python examples/serve_continuous_torch.py --slots 4    # full width on the card
"""

import argparse
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PROMPTS = ["a red flower", "a blue car", "an old house",
           "a wolf at night", "a sunny beach"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="StyleGAN2_ffhq_d")
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--chunk", type=int, default=4)
    ap.add_argument("--generations", type=int, default=8)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--weights", default="random:0")
    args = ap.parse_args()

    from clip_glass_torch.config import get_config
    from clip_glass_torch.fitness.problem import GenerationProblem
    from clip_glass_torch.serving import SearchServer

    config = get_config(args.config).replace(target=PROMPTS[0], weights=args.weights)
    clip_cfg = model_cfg = None
    if args.tiny:
        from clip_glass_torch.cli import _tinyfy
        config, clip_cfg, model_cfg = _tinyfy(config)

    problem = GenerationProblem(config, device=args.device, clip_cfg=clip_cfg,
                                model_cfg=model_cfg)
    server = SearchServer(problem, n_slots=args.slots, chunk=args.chunk, seed=0)
    tickets = []

    def client():
        for p in PROMPTS:                      # requests trickle in
            tickets.append((server.submit(p, n_gen=args.generations), p))
            time.sleep(0.2)
        while len(server.results) < len(tickets):
            time.sleep(0.1)
        server.stop()

    th = threading.Thread(target=client)
    th.start()
    server.run(forever=True)                   # tick until the client stops us
    th.join()
    for ticket, p in tickets:
        r = server.results[ticket]
        print(f"[{ticket}] {p!r}: best F = {float(r.pop_F.min()):+.4f} "
              f"after {r.state.gen} generations")
    s = server.stats
    print(f"served {s.completed} requests in {s.ticks} ticks; "
          f"slot occupancy {s.occupancy:.0%}")


if __name__ == "__main__":
    main()
