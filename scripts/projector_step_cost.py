#!/usr/bin/env python3
"""Seconds of one projector step (`Projector.step`: the plain-domain
synthesis through kernels 1-3 under grad, LPIPS-VGG16 and the backward) at
config-f 1024 px, fp32, B = 1, on one GPU, for one or more checkouts of the
repo in turn.

Each checkout runs in a process of its own (its own `clip_glass_torch`, its
own kernel build) and times STEPS steps after WARMUP, each fenced by a
synchronisation, with the weights of `chip_smoke.py` phase 25 (a synthesized
`Gs.pth`, LPIPS at its real geometry, seed 0). Prints one JSON line per
checkout. To compare two trees on the same card, name both in the order
parent, change, change, parent:

    python3 scripts/projector_step_cost.py build/parent . . build/parent
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WARMUP, STEPS = 5, 40


def measure(root: str) -> dict:
    sys.path.insert(0, HERE)
    import chip_smoke  # this checkout's weight helpers (import torch only)
    import torch

    sys.path.insert(0, os.path.abspath(root))  # the package under test
    from clip_glass_torch import projector as P
    from clip_glass_torch.models.stylegan2 import model as sg2

    with tempfile.TemporaryDirectory() as tmp:
        g_params, cfg = chip_smoke.synth_generator(tmp, sg2.CONFIG_F)
        proj = P.Projector(g_params, cfg, lpips_params=chip_smoke.lpips_weights(tmp),
                           device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    target = torch.rand((1, 3, cfg.resolution, cfg.resolution), generator=gen,
                        device="cuda")
    dl = proj.dlatent_avg[None, None, :].expand(1, cfg.num_latents, cfg.latent_size).clone()
    opt_vars = (dl, [torch.randn(s, generator=gen, device="cuda")
                     for s in cfg.noise_shapes()])
    state = P.adam_init([opt_vars[0], *opt_vars[1]])
    seconds = []
    for i in range(WARMUP + STEPS):
        draw = torch.randn(dl.shape, generator=gen, device="cuda")
        torch.cuda.synchronize()
        t = time.perf_counter()
        opt_vars, state, _, _ = proj.step(opt_vars, state, target, draw, 0.5)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t)
    seconds = seconds[WARMUP:]
    return {"root": root,
            "package": os.path.dirname(os.path.dirname(P.__file__)),
            "device": torch.cuda.get_device_name(0),
            "nvidia_smi": chip_smoke.smi_line(), "steps": STEPS,
            "step_s_median": statistics.median(seconds), "step_s_mean": statistics.mean(seconds),
            "step_s_min": min(seconds), "step_s_max": max(seconds)}


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(measure(argv[1])), flush=True)
        return 0
    for root in argv or ["."]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
