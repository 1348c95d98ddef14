#!/usr/bin/env python3
"""Where the time goes in one flagship fitness evaluation of the PyTorch port
on one GPU: StyleGAN2_ffhq_d (config-f 1024px G + D, CLIP ViT-B/32), pop 16,
bf16, random weights from seed 0, through the evaluation `eval_population`
runs: by default the s2d fitness path (the 512 and 1024 px levels in the
space-to-depth domain, the image handed over packed), with --plain the plain
domain (s2d_min_res=2**30). With --searches K, K searches of pop 16 in one
batched evaluation (`eval_population_batched`, as several --target run it):
the stages at K x 16 rows, D pooled per search.

Prints JSON lines:
  - stage times (CUDA events, mean of ITERS warm runs): G (mapping +
    synthesis + [0,1] scaling), CLIP (resize + image tower + cosine), D,
    the whole evaluation, and one NSGA-II step with the evaluation replaced
    by a constant (the evolutionary operators alone); on the s2d path the
    stages are the packed-image ones the evaluation chains;
  - torch.profiler over one warm evaluation: device time by kernel name (top
    entries), the sum of device time, the wall time, the device's idle
    share (1 - device time / wall time; one stream, so kernels never overlap),
    and the cuDNN convolutions by input shape with the device time of all
    the kernels each launched;
  - the card's name and power limit.
Writes the Chrome trace to --trace (default build/flagship_eval_trace.json).

Run on the card: python3 scripts/profile_torch_flagship.py [--plain] [--searches K]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from clip_glass_torch.config import get_config  # noqa: E402
from clip_glass_torch.evolve.algorithm import GAState, make_step  # noqa: E402
from clip_glass_torch.fitness.problem import GenerationProblem  # noqa: E402
from clip_glass_torch.models.stylegan2 import model as sg2  # noqa: E402

OUR_KERNELS = ("noise_bias_lrelu_kernel", "upsample2x_kernel", "upsample2x_tiled_kernel",
               "modulated_matmul_kernel", "modulated_matmul_mma_kernel",
               "s2d_conv2x2_wgmma_kernel", "s2d_conv2x2_bf16_kernel")
ITERS = 5  # warm runs per stage time
TOP = 25  # entries in each profile table


def log(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default=os.path.join(ROOT, "build", "flagship_eval_trace.json"))
    ap.add_argument("--plain", action="store_true",
                    help="the plain domain throughout (s2d_min_res=2**30)")
    ap.add_argument("--searches", type=int, default=1,
                    help="K searches of pop 16 in one batched evaluation")
    args = ap.parse_args()
    K = args.searches
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()

    config = get_config("StyleGAN2_ffhq_d").replace(
        target="the face of a man with brown eyes", weights="random:0", pop_size=16)
    model_cfg = (dataclasses.replace(sg2.CONFIG_F, s2d_min_res=2 ** 30) if args.plain
                 else sg2.CONFIG_F)
    problem = GenerationProblem(config, device="cuda", model_cfg=model_cfg)
    gen = problem.generator
    domain = "s2d" if gen._s2d_active else "plain"
    if domain == "s2d":
        g, clip, d = gen.generate_packed, gen.clip_similarity_packed, gen.discriminate_packed
    else:
        g, clip, d = gen.generate, gen.clip_similarity, gen.discriminate
    X = torch.randn((K * 16, config.n_var), generator=torch.Generator(device="cuda")
                    .manual_seed(0), device="cuda")
    targets = gen.encode_targets([config.target] * K)

    def evaluate():
        if K == 1:
            return gen.eval_population(X)
        return gen.eval_population_batched(X.reshape(K, 16, -1), targets)

    with torch.inference_mode():
        imgs = g(X)
        F0 = evaluate()
        stages = {
            "G": cuda_ms(lambda: g(X), ITERS),
            "CLIP": cuda_ms(lambda: clip(imgs), ITERS),
            "D": cuda_ms(lambda: d(imgs, None, K), ITERS),
            "evaluation": cuda_ms(evaluate, ITERS),
        }
        if K == 1:
            step = make_step(problem.make_algorithm().ops, lambda off: F0, 16)
            state = GAState(X, F0, 0)
            rng = torch.Generator(device="cuda").manual_seed(0)
            stages["nsga2_step_without_eval"] = cuda_ms(lambda: step(state, rng), ITERS)
    log({"domain": domain, "stage_ms": stages, "searches": K, "pop": 16, "dtype": "bfloat16",
         "nvidia_smi": smi})

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            t = time.perf_counter()
            evaluate()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3

    # device-side events only (kernels, memsets, copies): a CPU op's device
    # time repeats the time of the kernels it launched
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total_ms = sum(e.self_device_time_total for e in events) / 1e3
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    top = [{"name": e.key[:120], "device_ms": e.self_device_time_total / 1e3,
            "calls": e.count} for e in events[:TOP]]
    ours = {k: sum(e.self_device_time_total for e in events if k in e.key) / 1e3
            for k in OUR_KERNELS}
    convs = [e for e in prof.key_averages(group_by_input_shape=True)
             if e.key in ("aten::cudnn_convolution", "aten::cudnn_convolution_transpose")]
    convs.sort(key=lambda e: e.device_time_total, reverse=True)
    top_convs = [{"name": e.key, "input_shapes": e.input_shapes[:2],
                  "device_ms": e.device_time_total / 1e3, "calls": e.count}
                 for e in convs[:TOP]]
    log({"profile": "one evaluation", "domain": domain, "searches": K, "wall_ms": wall_ms,
         "device_ms": total_ms,
         "idle_share": max(0.0, 1.0 - total_ms / wall_ms),
         "kernel_launches": sum(e.count for e in events),
         "hand_written_kernels_ms": ours, "top": top, "top_convs": top_convs,
         "nvidia_smi": smi})
    os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
    prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
