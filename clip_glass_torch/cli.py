"""CLI entry point: the reference `run.py` contract on the PyTorch/CUDA port.

Reference behavior mirrored (reference run.py):
- flags --config --target --generations --save-each --tmp-folder --device
  (run.py:15-24); --device defaults to "cuda", and "cpu" runs on the host
- periodic artifact dumps `genetic-it-<N>.jpg` every save-each generations,
  final dump `genetic-it-final.jpg`, GA populations sorted by fitness
  (run.py:29-51)
- `genetic_result` pickle of {X, F, G, CV} (run.py:79-84)
- Pareto scatter `F.jpg` for two-objective runs (run.py:86-89)
- `ls_result` latent dump (run.py:92-101; npz of decoded latents here)
- pseudo-weights/ASF decision -> `output.jpg` (run.py:103-125)

Additions, as in the JAX package's CLI: --pop-size/--seed overrides,
--weights (a directory of converted checkpoints, or `random:<seed>`),
--clip-weights, --resume (bit-exact resume from `ga_state.npz`), --profile.
The JAX package's other flags are parsed and refused, each naming the
ROADMAP item that ports it.
"""

from __future__ import annotations

import argparse
import os
import pickle
import time

import numpy as np

DEFAULT_TARGET = "a wolf at night with the moon in the background"

# flag (argparse dest) -> why this package refuses it
REFUSED = {
    "serve": "serve mode is ROADMAP item 12",
    "slots": "serve mode is ROADMAP item 12",
    "search_microbatch": "multi-search batching is ROADMAP item 12",
    "quantize": "the int8 fitness is ROADMAP item 13",
    "mesh": "population sharding is ROADMAP item 16",
    "distributed": "multi-host runs are ROADMAP item 16",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="clip-glass-torch")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    p.add_argument("--config", type=str, default="DeepMindBigGAN512")
    p.add_argument("--generations", type=int, default=500)
    p.add_argument("--save-each", type=int, default=50)
    p.add_argument("--tmp-folder", type=str, default="./tmp")
    p.add_argument("--target", type=str, action="append", default=None,
                   help="search target (text prompt). Default: 'a wolf at night "
                        "with the moon in the background' (reference run.py:22). "
                        "One only: several targets are ROADMAP item 12")
    p.add_argument("--pop-size", type=int, default=None)
    p.add_argument("--eval-microbatch", type=int, default=None,
                   help="evaluate the population in sequential chunks of this "
                        "size (must divide the population)")
    p.add_argument("--search-microbatch", type=int, default=None,
                   help="not ported: " + REFUSED["search_microbatch"])
    p.add_argument("--serve", type=str, default=None, metavar="FILE",
                   help="not ported: " + REFUSED["serve"])
    p.add_argument("--slots", type=int, default=4,
                   help="not ported: " + REFUSED["slots"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quantize", type=str, default="", choices=["", "int8"],
                   help="not ported: " + REFUSED["quantize"])
    p.add_argument("--weights", type=str, default=None,
                   help="override config weights: a directory of converted "
                        "checkpoints (Gs.npz + Gs_cfg.json, D.npz, optional "
                        "Gs_noise.npz), or 'random:<seed>' for random init")
    p.add_argument("--clip-weights", type=str, default=None,
                   help="a converted CLIP ViT-B/32 .npz (with its _cfg.json), or "
                        "'random:<seed>'; default: ./weights/clip/ViT-B-32.npz "
                        "if present, else random:0")
    p.add_argument("--resume", action="store_true",
                   help="resume from <tmp-folder>/ga_state.npz")
    p.add_argument("--mesh", action="store_true",
                   help="not ported: " + REFUSED["mesh"])
    p.add_argument("--distributed", type=str, default=None, metavar="SPEC",
                   help="not ported: " + REFUSED["distributed"])
    p.add_argument("--verbose", action=argparse.BooleanOptionalAction, default=True,
                   help="print the per-chunk, rate, dump and wallclock lines "
                        "(the default; --no-verbose is quiet)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny model variants (smoke tests / CI; random weights)")
    p.add_argument("--profile", type=str, default="",
                   help="write a torch.profiler Chrome trace to this directory")
    return p


def _refuse_unported(parser: argparse.ArgumentParser, args) -> None:
    """parser.error (exit 2) for a flag or config this package does not run;
    a refused flag at its default value asks for nothing and passes."""
    for dest, why in REFUSED.items():
        if getattr(args, dest) != parser.get_default(dest):
            parser.error(f"--{dest.replace('_', '-')}: {why}")
    if args.target and len(args.target) > 1:
        parser.error("more than one --target: multi-search batching is ROADMAP item 12")
    from clip_glass_torch.config import get_config, list_configs
    from clip_glass_torch.evolve.algorithm import UNPORTED

    if args.config not in list_configs():
        parser.error(f"--config {args.config}: unknown; choose from {list_configs()}")
    model = get_config(args.config).model
    if model in UNPORTED:
        parser.error(f"--config {args.config}: the {model} configs are not ported "
                     f"yet ({UNPORTED[model]})")


def _tinyfy(config):
    """Shrink a config to the TINY model variants (CPU-runnable smoke mode)."""
    from clip_glass_torch.models.clip import model as clip_model
    from clip_glass_torch.models.stylegan2 import model as sg2

    return (config.replace(dim_z=32, n_var=32, weights="random:0"),
            clip_model.TINY, sg2.TINY)


def decode_latents_npz(config, X: np.ndarray):
    """ls_result content (reference run.py:92-101 saves the latent module's
    state dict; here: the decoded latent arrays; StyleGAN2's decode is the
    identity)."""
    return {"z": np.asarray(X)}


def _final_artifacts(problem, config, res, folder):
    """Result artifacts (reference run.py:79-125): genetic_result pickle,
    Pareto scatter F.jpg (2-obj), ls_result latents, decision -> output.jpg."""
    import torch

    from clip_glass_torch.evolve.decision import pick
    from clip_glass_torch.fitness.generator import quantize_u8
    from clip_glass_torch.utils.plotting import save_scatter

    res_X, res_F = res.X.numpy(), res.F.numpy()
    pop_X, pop_F = res.pop_X.numpy(), res.pop_F.numpy()
    with open(os.path.join(folder, "genetic_result"), "wb") as f:
        pickle.dump(dict(X=res_X, F=res_F, G=res.G.numpy(), CV=res.CV.numpy()), f)

    if config.n_obj == 2:
        save_scatter(res_F, os.path.join(folder, "F.jpg"),
                     labels=("similarity", "discriminator"))
        np.savez(os.path.join(folder, "ls_result"),
                 **decode_latents_npz(config, pop_X))
        X_best = np.atleast_2d(np.atleast_2d(res_X)[pick(res_F, (0, 1))])
    else:  # sorted by fitness (reference run.py:96-101)
        pop_sorted = pop_X[np.argsort(pop_F[:, 0], kind="stable")]
        np.savez(os.path.join(folder, "ls_result"),
                 **decode_latents_npz(config, pop_sorted))
        X_best = np.atleast_2d(res_X)

    with torch.inference_mode():
        generated = problem.generator.generate(
            torch.from_numpy(X_best).to(problem.device))
        u8 = quantize_u8(generated).cpu().numpy()
    problem.generator.save(u8, os.path.join(folder, "output.jpg"))


def main(argv=None) -> int:
    t0 = time.perf_counter()
    phases = {}  # wallclock breakdown (printed when --verbose)

    parser = build_parser()
    args = parser.parse_args(argv)
    _refuse_unported(parser, args)
    target = args.target[0] if args.target else DEFAULT_TARGET

    import torch

    from clip_glass_torch.config import get_config
    from clip_glass_torch.core.checkpoint import (checkpoint_config_name, load_state,
                                                  save_state)
    from clip_glass_torch.core.profiling import GenerationMeter, Timer, device_trace
    from clip_glass_torch.evolve.algorithm import minimize
    from clip_glass_torch.fitness.generator import quantize_u8
    from clip_glass_torch.fitness.problem import GenerationProblem

    phases["imports"] = time.perf_counter() - t0

    config = get_config(args.config).replace(
        target=target, tmp_folder=args.tmp_folder, seed=args.seed,
        generations=args.generations, save_each=args.save_each)
    if args.pop_size:
        config = config.replace(pop_size=args.pop_size)
    if args.eval_microbatch:
        config = config.replace(eval_microbatch=args.eval_microbatch)
    if args.weights:
        config = config.replace(weights=args.weights)

    clip_cfg = model_cfg = None
    if args.tiny:
        config, clip_cfg, model_cfg = _tinyfy(config)

    if args.resume:
        saved = checkpoint_config_name(config.tmp_folder)
        if saved is not None and saved != config.name:
            parser.error(f"--resume: the checkpoint in {config.tmp_folder} was written "
                         f"by a {saved or 'unnamed'} search, not {config.name}")

    os.makedirs(config.tmp_folder, exist_ok=True)
    clip_weights = args.clip_weights
    if clip_weights is None:
        default_clip = "./weights/clip/ViT-B-32.npz"
        clip_weights = (default_clip
                        if os.path.exists(default_clip) and not args.tiny
                        else "random:0")

    problem = GenerationProblem(config, device=args.device, clip_weights=clip_weights,
                                clip_cfg=clip_cfg, model_cfg=model_cfg)
    algorithm = problem.make_algorithm()
    rng = algorithm.generator(config.seed)
    phases["setup"] = time.perf_counter() - t0 - sum(phases.values())

    meter = GenerationMeter(config.pop_size)
    # artifact dumps: the device work (render, quantize, copy to the host)
    # runs here on the main thread; a one-worker saver thread (`saver`,
    # below) assembles the grid and encodes the JPEG while the next chunk of
    # generations runs
    from concurrent.futures import ThreadPoolExecutor
    pending = []   # (name, render seconds, future of the write's seconds)

    def _write(u8, path):
        with Timer() as write:
            problem.generator.save(u8, path)
        return write.seconds

    @torch.inference_mode()
    def _dump(state):
        with Timer() as render:
            X = state.X
            if config.n_obj == 1:  # sorted by fitness (reference run.py:36-38)
                X = X[torch.argsort(state.F[:, 0], stable=True)]
            u8 = quantize_u8(problem.generator.generate(X)).cpu().numpy()
        name = (f"genetic-it-{state.gen}.jpg" if state.gen < config.generations
                else "genetic-it-final.jpg")
        pending.append((name, render.seconds, saver.submit(
            _write, u8, os.path.join(config.tmp_folder, name))))

    def save_callback(state):
        _dump(state)
        save_state(state, rng, config.tmp_folder, config.name)
        # the first chunk's wall time holds the kernel builds and the
        # libraries' warm-up: rebaseline there so rates are steady-state
        meter.set_generation(state.gen,
                             rebaseline=(meter.generation == 0 and state.gen > 0))
        if args.verbose and meter.gens_per_sec > 0:
            print(f"  rate: {meter.gens_per_sec:.2f} gen/s "
                  f"({meter.candidates_per_sec:.1f} candidates/s)")

    state = None
    if args.resume:
        try:
            state = load_state(config.tmp_folder, rng)
        except ValueError as e:
            parser.error(f"--resume: {e}")
        if state is None:
            print("no checkpoint found; starting fresh")
        elif (tuple(state.X.shape), tuple(state.F.shape)) != (
                (config.pop_size, config.n_var), (config.pop_size, config.n_obj)):
            parser.error(f"--resume: the checkpoint's X {tuple(state.X.shape)} and F "
                         f"{tuple(state.F.shape)} do not fit this search ({config.name}, "
                         f"pop {config.pop_size})")
    if state is None:
        state = algorithm.init(rng)

    remaining = config.generations - state.gen
    phases["init(gen0)"] = time.perf_counter() - t0 - sum(phases.values())
    with ThreadPoolExecutor(max_workers=1) as saver:
        with device_trace(args.profile):
            res = minimize(algorithm, n_gen=max(remaining, 0), generator=rng,
                           callback=save_callback, save_each=config.save_each,
                           verbose=args.verbose, state=state)
        writes = [fut.result() for _, _, fut in pending]  # surface any write error
    phases["search+dumps"] = time.perf_counter() - t0 - sum(phases.values())

    # ---- final artifacts (reference run.py:79-125)
    _final_artifacts(problem, config, res, config.tmp_folder)
    phases["final_artifacts"] = time.perf_counter() - t0 - sum(phases.values())
    if args.verbose:
        for (name, render_s, _), write_s in zip(pending, writes):
            print(f"dump {name}: render={render_s:.3f}s write={write_s:.3f}s")
        total = time.perf_counter() - t0
        parts = "  ".join(f"{k}={v:.3f}s" for k, v in phases.items())
        print(f"wallclock: total={total:.3f}s  {parts}")
    # main keeps nothing (the closures see these names through their cells):
    # free the card's cache for the next run in the same process
    del problem, algorithm, res, state
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
