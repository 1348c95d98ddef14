#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: candidates scored per second per card.

The port's counterpart of the JAX package's `bench.py`, which stays the JAX
bench. The workload is the flagship by default: StyleGAN2_ffhq_d, complete
NSGA-II generations (selection, SBX and polynomial mutation, duplicate
resampling, the evaluation: config-f 1024 px synthesis, CLIP ViT-B/32
scoring and the discriminator's hinge, then survival) at pop 16, bf16,
random weights from seed 0. The search advances one eager step a
generation, as the port's CLI does.

Two warm-up generations, then `BENCH_REPEATS` timed windows of `BENCH_GENS`
generations each, fenced by `torch.cuda.synchronize()` on both sides; the
fastest window sets the rate (bench.py:131-151). The state runs on through
the windows, so the search ends after 2 + repeats x gens generations.

Prints one JSON line in bench.py's schema: `metric`, `value`, `unit`,
`vs_baseline` (null: no TPU or CPU rate is this bench's baseline),
`model_gflops_per_candidate` and `model_tflops_per_sec_per_chip` (from
clip_glass_torch/core/flops.py), `device_kind`
(`torch.cuda.get_device_name()`), `mfu` (null for a card without a known
peak), and beside them each window's seconds, the kernels' launches per
evaluation and `checksum_F` under BENCH_CHECKSUM.

Environment (bench.py's names):
  BENCH_CONFIG        config name (default StyleGAN2_ffhq_d)
  BENCH_POP           population (default 16 for the flagship, else the
                      config's own)
  BENCH_GENS          generations a timed window (default 10)
  BENCH_QUANT         "int8": the quantized fitness (ops/quant.py)
  BENCH_QUANT_MIN_CH  its narrowest eligible conv
  BENCH_MICROBATCH    eval_microbatch; by default 32 for StyleGAN2 and
                      DeepMindBigGAN512 populations above 32
  BENCH_TARGETS       K searches batched (evolve/batched.py), one target each
  BENCH_SEARCH_MB     their search_microbatch
  BENCH_REPEATS       timed windows (default 3; 1 under BENCH_PROFILE)
  BENCH_PROFILE       a directory: torch.profiler over the one window,
                      written to <dir>/trace.json
  BENCH_CHECKSUM      set: add checksum_F, the final population's F summed
                      in float64 (bench.py's), checksum_F_columns, each
                      objective's sum, and sha256_F, the hash of F's
                      float32 bytes: F is equal bitwise only where the
                      hashes are
Not ported: BENCH_CHUNK and BENCH_DUMP_HLO, the JAX bench's XLA dispatch
and HLO knobs, which have no eager counterpart.

Run: python3 bench_torch.py [--device cuda|cpu]   (the card by default;
without one it raises)
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time
from typing import Optional

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

WARMUP = 2
FLAGSHIP = "StyleGAN2_ffhq_d"
TEXT_TARGET = "the face of a man with brown eyes"
IMAGE_TARGET = os.path.join(ROOT, "examples", "gpt2_images", "dog.jpeg")
# the largest population a card evaluates in one piece by default
# (bench.py:59-66): beyond it the evaluation runs in chunks of this size
SAFE_MICROBATCH = {"StyleGAN2": 32, "DeepMindBigGAN512": 32}


def bench_config(name: str = FLAGSHIP, pop: Optional[int] = None, quant: str = "",
                 quant_min_ch: Optional[int] = None, microbatch: Optional[int] = None):
    """The bench's config of `name`: its target, random weights from seed 0,
    bf16, `pop` (default as BENCH_POP's), the quantization and the
    microbatch (bench.py:37-66)."""
    from clip_glass_torch.config import get_config

    config = get_config(name)
    if pop is None:
        pop = 16 if name == FLAGSHIP else config.pop_size
    target = IMAGE_TARGET if config.task == "img2txt" else TEXT_TARGET
    config = config.replace(target=target, weights="random:0", pop_size=pop,
                            compute_dtype="bfloat16")
    if quant:
        config = config.replace(quantize=quant)
        if quant_min_ch is not None:
            config = config.replace(quantize_min_ch=quant_min_ch)
    safe = SAFE_MICROBATCH.get("StyleGAN2" if name.startswith("StyleGAN2") else name)
    if microbatch:
        config = config.replace(eval_microbatch=microbatch)
    elif safe and pop > safe:
        config = config.replace(eval_microbatch=safe)
    return config


def kernel_wrappers() -> dict:
    """The hand-written kernels' wrappers by name (each counts its launches)."""
    from clip_glass_torch.ops import bias_act, conv_s8, modulated_conv, s2d, upfirdn

    return {k.__name__: k for k in (bias_act.noise_bias_lrelu, upfirdn.upsample2x,
                                    modulated_conv.modulated_matmul, s2d.s2d_conv2x2,
                                    conv_s8.conv_s8)}


def _targets(config, n_targets: int) -> list:
    if config.task == "img2txt":
        return [config.target] * n_targets
    return [f"{config.target}, variant {i}" for i in range(n_targets)]


@torch.inference_mode()
def measure(config, pop: int, gens: int, repeats: int = 3, n_targets: int = 1,
            search_mb: Optional[int] = None, device=None, profile: Optional[str] = None,
            checksum: bool = False, clip_cfg=None, model_cfg=None) -> dict:
    """Time `repeats` windows of `gens` generations of `config`'s search at
    population `pop` (K = `n_targets` searches batched) after WARMUP
    generations, from seed 0, on `device` (the card by default). Returns
    bench.py's record (module docstring). `clip_cfg` / `model_cfg` replace
    the full-size models (the tests' TINY ones)."""
    from clip_glass_torch.core import flops
    from clip_glass_torch.core.device import resolve_device
    from clip_glass_torch.core.profiling import device_trace
    from clip_glass_torch.evolve.batched import make_batched
    from clip_glass_torch.fitness.problem import GenerationProblem

    dev = resolve_device(device)
    config = config.replace(pop_size=pop)
    problem = GenerationProblem(config, device=dev, clip_cfg=clip_cfg, model_cfg=model_cfg)
    if n_targets > 1:
        algorithm = make_batched(problem, _targets(config, n_targets),
                                 search_microbatch=search_mb)
        generators = algorithm.generators(0)
        state = algorithm.init(generators)

        def step(s):
            return algorithm.step(s, generators)
    else:
        algorithm = problem.make_algorithm()
        generator = algorithm.generator(0)
        state = algorithm.init(generator)
        step_fn = algorithm.step_fn()

        def step(s):
            return step_fn(s, generator)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(WARMUP):
        state = step(state)
    sync()

    kernels = kernel_wrappers()
    before = {name: k.launches for name, k in kernels.items()}
    if profile:
        repeats = 1
    seconds = []
    with device_trace(profile, dev):
        for _ in range(max(1, repeats)):
            sync()
            t0 = time.perf_counter()
            for _ in range(gens):
                state = step(state)
            sync()
            seconds.append(time.perf_counter() - t0)
    evaluations = len(seconds) * gens
    best = min(seconds)
    n_cards = 1
    rate = pop * n_targets * gens / best / n_cards

    desc = (f"{config.name}, pop={pop}, full "
            f"{'NSGA-II' if config.algorithm == 'nsga2' else 'GA'} generations")
    if n_targets > 1:
        desc += f", {n_targets} searches batched"
    if config.quantize:
        desc += f", {config.quantize}"
    fpc = flops.fitness_flops_per_candidate(config, problem.generator.model_cfg,
                                            problem.generator.clip_cfg)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    peak = flops.chip_peak_flops(kind) if dev.type == "cuda" else None
    out = {
        "metric": f"candidates_scored_per_sec_per_chip ({desc})",
        "value": rate,
        "unit": "candidates/s/chip",
        "vs_baseline": None,
        "model_gflops_per_candidate": fpc / 1e9,
        "model_tflops_per_sec_per_chip": fpc * rate / 1e12,
        "device_kind": kind,
        "mfu": fpc * rate / peak if peak else None,
        "best_s": best,
        "repeat_s": seconds,
        "generations": gens,
        "warmup_generations": WARMUP,
        "evaluations_timed": evaluations,
        "cards": n_cards,
        "launches_per_evaluation": {name: (k.launches - before[name]) / evaluations
                                    for name, k in kernels.items()},
    }
    if checksum:
        out.update(checksums(state.F))
    return out


def checksums(F: torch.Tensor) -> dict:
    """checksum_F, F summed in float64 (bench.py's; a hinge of 1e21 hides
    the similarities below its spacing), checksum_F_columns, each
    objective's sum, and sha256_F, the hash of F's float32 bytes."""
    F = np.ascontiguousarray(F.float().cpu().numpy())
    F64 = F.astype(np.float64)
    return {"checksum_F": f"{float(F64.sum()):.17g}",
            "checksum_F_columns": [f"{float(c):.17g}"
                                   for c in F64.reshape(-1, F.shape[-1]).sum(axis=0)],
            "sha256_F": hashlib.sha256(F.tobytes()).hexdigest()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Candidates scored per second per card on the port (one JSON line); "
                    "the workload comes from the BENCH_* environment variables")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    args = p.parse_args(argv)
    env = os.environ
    name = env.get("BENCH_CONFIG", FLAGSHIP)
    pop = int(env["BENCH_POP"]) if env.get("BENCH_POP") else None
    config = bench_config(
        name, pop, quant=env.get("BENCH_QUANT", ""),
        quant_min_ch=int(env["BENCH_QUANT_MIN_CH"]) if env.get("BENCH_QUANT_MIN_CH") else None,
        microbatch=int(env["BENCH_MICROBATCH"]) if env.get("BENCH_MICROBATCH") else None)
    smb = env.get("BENCH_SEARCH_MB")
    out = measure(config, config.pop_size, int(env.get("BENCH_GENS", "10")),
                  repeats=int(env.get("BENCH_REPEATS", "3")),
                  n_targets=int(env.get("BENCH_TARGETS", "1")),
                  search_mb=int(smb) if smb else None, device=args.device,
                  profile=env.get("BENCH_PROFILE") or None,
                  checksum=bool(env.get("BENCH_CHECKSUM")))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
