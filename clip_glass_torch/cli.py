"""CLI entry point: the reference `run.py` contract on the PyTorch/CUDA port.

Reference behavior mirrored (reference run.py):
- flags --config --target --generations --save-each --tmp-folder --device
  (run.py:15-24); --device defaults to "cuda", and "cpu" runs on the host
- periodic artifact dumps `genetic-it-<N>.<ext>` every save-each
  generations, final dump `genetic-it-final.<ext>`, GA populations sorted by
  fitness (run.py:29-51); <ext> is jpg for txt2img, txt (captions) for
  GPT-2's img2txt
- `genetic_result` pickle of {X, F, G, CV} (run.py:79-84)
- Pareto scatter `F.jpg` for two-objective runs (run.py:86-89)
- `ls_result` latent dump (run.py:92-101; npz of decoded latents here)
- pseudo-weights/ASF decision -> `output.<ext>` (run.py:103-125)

The GA's sort by fitness is numpy's default `np.argsort` on the host copy of
F, as in the JAX CLI, so tied fitnesses (every row of a GPT-2 population
whose captions overflowed CLIP's context) order the artifacts the same way.

Additions, as in the JAX package's CLI: --pop-size/--seed overrides,
--weights (the reference's checkpoints, converted npz trees, or
`random:<seed>`), --clip-weights, --resume (bit-exact resume from `ga_state.npz`), --profile.
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
                   help="search target: a text prompt, or for GPT2 an image path. "
                        "Default: 'a wolf at night with the moon in the background' "
                        "(reference run.py:22). One only: several targets are ROADMAP "
                        "item 12")
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
                   help="override config weights: for StyleGAN2 a directory with the "
                        "reference's Gs.pth (or G.pth) and D.pth, or converted "
                        "checkpoints (Gs.npz + Gs_cfg.json, D.npz, optional "
                        "Gs_noise.npz); for BigGAN and GPT-2 the reference's "
                        "pytorch_model.bin / gpt2-pytorch_model.bin or a converted .npz "
                        "(with its _cfg.json); or 'random:<seed>' for random init")
    p.add_argument("--clip-weights", type=str, default=None,
                   help="an OpenAI CLIP checkpoint (ViT-B-32.pt or RN50.pt), a "
                        "converted .npz (with its _cfg.json), or 'random:<seed>'; "
                        "default: ./weights/clip/ViT-B-32.npz if present, else random:0")
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
    from clip_glass_torch.config import list_configs

    if args.config not in list_configs():
        parser.error(f"--config {args.config}: unknown; choose from {list_configs()}")


def _tinyfy(config):
    """Shrink a config to the TINY model variants (CPU-runnable smoke mode)."""
    from clip_glass_torch.models.biggan import model as bg
    from clip_glass_torch.models.clip import model as clip_model
    from clip_glass_torch.models.gpt2 import model as g2
    from clip_glass_torch.models.stylegan2 import model as sg2

    if config.model == "biggan":
        return (config.replace(dim_z=16, num_classes=10, n_var=26, resolution=8,
                               weights="random:0"),
                clip_model.TINY, bg.TINY)
    if config.model == "gpt2":
        return (config.replace(dim_z=6, n_var=6, max_tokens_len=5, weights="random:0"),
                clip_model.TINY, g2.TINY)
    return (config.replace(dim_z=32, n_var=32, weights="random:0"),
            clip_model.TINY, sg2.TINY)


def decode_latents_npz(config, X: np.ndarray):
    """ls_result content (reference run.py:92-101 saves the latent module's
    state dict; here: the decoded latent arrays: BigGAN's z and class
    vector, StyleGAN2's latents as they are, GPT-2's int32 token ids)."""
    import torch

    from clip_glass_torch.fitness.latent import decode_biggan, decode_gpt2

    if config.latent == "biggan":
        z, cv = decode_biggan(torch.as_tensor(np.asarray(X)), config.dim_z)
        return {"z": z.numpy(), "class_labels": cv.numpy()}
    if config.latent == "gpt2":
        return {"z": decode_gpt2(torch.as_tensor(np.asarray(X)))[0].numpy()}
    return {"z": np.asarray(X)}


def artifact_ext(config) -> str:
    """The extension of the dumps and of `output.*` (JAX CLI: cli.py:145)."""
    return "jpg" if config.task == "txt2img" else "txt"


def fitness_order(F: np.ndarray) -> np.ndarray:
    """The GA's dump and ls_result order: numpy's default argsort of the
    first objective on the host, the JAX CLI's call (cli.py:162, :390), so
    ties fall the same way in both packages."""
    return np.argsort(F[:, 0])


def _final_artifacts(problem, config, res, folder):
    """Result artifacts (reference run.py:79-125): genetic_result pickle,
    Pareto scatter F.jpg (2-obj), ls_result latents, decision -> output.<ext>."""
    import torch

    from clip_glass_torch.evolve.decision import pick
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
        pop_sorted = pop_X[fitness_order(pop_F)]
        np.savez(os.path.join(folder, "ls_result"),
                 **decode_latents_npz(config, pop_sorted))
        X_best = np.atleast_2d(res_X)

    rendered = problem.generator.render(torch.from_numpy(X_best).to(problem.device))
    problem.generator.save(rendered, os.path.join(folder, f"output.{artifact_ext(config)}"))


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
    # below) assembles the grid and encodes the JPEG (or decodes the
    # captions) while the next chunk of generations runs
    from concurrent.futures import ThreadPoolExecutor
    pending = []   # (name, render seconds, future of the write's seconds)

    def _write(rendered, path):
        with Timer() as write:
            problem.generator.save(rendered, path)
        return write.seconds

    ext = artifact_ext(config)

    @torch.inference_mode()
    def _dump(state):
        with Timer() as render:
            X = state.X
            if config.n_obj == 1:  # sorted by fitness (reference run.py:36-38)
                order = fitness_order(state.F.cpu().numpy())
                X = X[torch.from_numpy(order).to(X.device)]
            rendered = problem.generator.render(X)
        name = (f"genetic-it-{state.gen}.{ext}" if state.gen < config.generations
                else f"genetic-it-final.{ext}")
        pending.append((name, render.seconds, saver.submit(
            _write, rendered, os.path.join(config.tmp_folder, name))))

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
