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
`random:<seed>`), --clip-weights, --resume (bit-exact resume from `ga_state.npz`), --profile;
several --target (K searches batched in one run, evolve/batched.py: one
`search-NN/` folder each with `target.txt` and its artifact set, one
`ga_state.npz` at the root) with --search-microbatch; --serve FILE|- with
--slots (serving.SearchServer: one `request-NNNN/` folder per request with
`target.txt` and the result artifacts); --quantize int8 (the int8 fitness,
ops/quant.py, calibrated at setup from the seed); --mesh (the evaluation's
rows split over the cards, parallel/mesh.py) and --distributed SPEC (one
process a card in a torch.distributed process group, parallel/
distributed.py; implies --mesh), as the JAX CLI: every rank runs the search
on the whole state, rank 0 alone writes the artifacts, and --serve and
GPT2's host round trip refuse a process group.
"""

from __future__ import annotations

import argparse
import os
import pickle
import time

import numpy as np

DEFAULT_TARGET = "a wolf at night with the moon in the background"


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
                        "(reference run.py:22). Repeat the flag for several searches "
                        "batched in one run, each in its own search-NN/ folder")
    p.add_argument("--pop-size", type=int, default=None)
    p.add_argument("--eval-microbatch", type=int, default=None,
                   help="evaluate the population in sequential chunks of this "
                        "size (must divide the population)")
    p.add_argument("--search-microbatch", type=int, default=None,
                   help="with several --target (or --serve): evaluate the searches "
                        "in chunks of this many (must divide their count); GPT2: "
                        "decode in groups of this many searches")
    p.add_argument("--serve", type=str, default=None, metavar="FILE",
                   help="serve mode: read one target a line from FILE ('-': stdin) "
                        "and run each as a request through --slots resident "
                        "searches; results in <tmp-folder>/request-NNNN/")
    p.add_argument("--slots", type=int, default=4,
                   help="serve mode: searches resident at once")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quantize", type=str, default="", choices=["", "int8"],
                   help="int8: run the frozen models' wide convs as int8 convs on the "
                        "card's int8 tensor cores (activation scales calibrated at "
                        "setup; an approximate fitness, ops/quant.py). Artifacts are "
                        "rendered in full precision")
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
                   help="split each evaluation's rows over the cards (every visible "
                        "card; under --distributed each rank's own); F is unchanged")
    p.add_argument("--distributed", type=str, default=None, metavar="SPEC",
                   help="join a torch.distributed process group, one process a card: "
                        "'auto' (torchrun's variables) or '<host:port>,<num>,<id>' "
                        "(default: $CGT_DISTRIBUTED); implies --mesh; NCCL on cards, "
                        "gloo with --device cpu")
    p.add_argument("--verbose", action=argparse.BooleanOptionalAction, default=True,
                   help="print the per-chunk, rate, dump and wallclock lines "
                        "(the default; --no-verbose is quiet)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny model variants (smoke tests / CI; random weights)")
    p.add_argument("--profile", type=str, default="",
                   help="write a torch.profiler Chrome trace to this directory")
    return p


def _refuse_unknown(parser: argparse.ArgumentParser, args) -> None:
    """parser.error (exit 2) for a config this package does not know."""
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


def _serve_mode(server, problem, config, args) -> int:
    """The CLI's front of serving.SearchServer (the JAX CLI's `_serve_mode`,
    cli.py:189-275): a reader thread feeds `server`'s queue from the --serve
    file or stdin, one target a line, while this thread ticks its --slots
    resident searches (`--save-each` generations a tick); each finished
    request gets `request-NNNN/` with `target.txt` and the result artifacts
    (reference run.py:79-125), written by a one-worker saver thread while
    the next tick runs. A writer's error ends the serve at once."""
    import sys
    import threading
    from concurrent.futures import ThreadPoolExecutor

    # opened here, so that a bad path fails before any thread starts
    src = sys.stdin if args.serve == "-" else open(args.serve)
    eof = threading.Event()

    def reader():
        try:
            for line in src:
                target = line.strip()
                if target:
                    ticket = server.submit(target, n_gen=config.generations)
                    if args.verbose:
                        print(f"[serve] queued #{ticket}: {target!r}", flush=True)
        finally:
            if src is not sys.stdin:
                src.close()
            eof.set()

    def write(ticket, res):
        folder = os.path.join(config.tmp_folder, f"request-{ticket:04d}")
        os.makedirs(folder, exist_ok=True)
        with open(os.path.join(folder, "target.txt"), "w") as f:
            f.write(server.meta[ticket])
        _final_artifacts(problem, config, res, folder)
        if args.verbose:
            print(f"[serve] done #{ticket}: best F={float(res.pop_F.min()):+.4f} -> {folder}",
                  flush=True)

    th = threading.Thread(target=reader, daemon=True)
    th.start()
    written = {}   # ticket -> future of its artifacts
    with ThreadPoolExecutor(max_workers=1) as saver:
        while True:
            worked = server.tick()
            for ticket in sorted(set(server.results) - set(written)):
                written[ticket] = saver.submit(write, ticket, server.results[ticket])
            for fut in written.values():
                if fut.done():
                    fut.result()   # a writer's error ends the serve now
            if not worked:
                if eof.is_set() and not server.pending() and not server.active():
                    break
                time.sleep(0.05)
        th.join()
        for fut in written.values():
            fut.result()
    s = server.stats
    if args.verbose:
        print(f"[serve] {s.completed} requests in {s.ticks} ticks, "
              f"slot occupancy {s.occupancy:.0%}")
    return 0


def main(argv=None) -> int:
    t0 = time.perf_counter()
    phases = {}  # wallclock breakdown (printed when --verbose)

    parser = build_parser()
    args = parser.parse_args(argv)
    _refuse_unknown(parser, args)
    targets = args.target or [DEFAULT_TARGET]
    if args.serve:
        if args.resume:
            parser.error("--serve does not take --resume: a server's state is resident "
                         "and per request; submit unfinished targets again")
        if args.serve != "-" and not os.path.exists(args.serve):
            parser.error(f"--serve file not found: {args.serve}")

    import torch

    from clip_glass_torch.parallel import distributed as dist
    from clip_glass_torch.parallel import make_mesh

    on_cpu = torch.device(args.device).type == "cpu"
    # before any CUDA use: the rank takes its card here
    try:
        dist.initialize(args.distributed, backend="gloo" if on_cpu else None)
    except ValueError as e:
        parser.error(f"--distributed: {e}")
    primary = dist.is_primary()
    if dist.active():
        if args.serve:
            parser.error("--serve is one process: the server splits its slots over "
                         "this process's cards; run one server a host")
        if not args.mesh:
            args.mesh = True   # a run over several processes is a sharded one
            if primary and args.verbose:
                print(f"[distributed] {dist.world_size()} processes; --mesh implied")
    verbose = args.verbose and primary

    from clip_glass_torch.config import get_config
    from clip_glass_torch.core.checkpoint import (checkpoint_config_name, load_state,
                                                  save_state)
    from clip_glass_torch.core.profiling import GenerationMeter, Timer, device_trace
    from clip_glass_torch.evolve.algorithm import minimize
    from clip_glass_torch.evolve.batched import make_batched, minimize_batched
    from clip_glass_torch.fitness.problem import GenerationProblem

    phases["imports"] = time.perf_counter() - t0

    config = get_config(args.config).replace(
        target=targets[0], tmp_folder=args.tmp_folder, seed=args.seed,
        generations=args.generations, save_each=args.save_each)
    if args.pop_size:
        config = config.replace(pop_size=args.pop_size)
    if args.eval_microbatch:
        config = config.replace(eval_microbatch=args.eval_microbatch)
    if args.weights:
        config = config.replace(weights=args.weights)
    if args.quantize:
        config = config.replace(quantize=args.quantize)

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

    if dist.active() and config.task == "img2txt":
        parser.error("GPT2's host round trip reads the population on the host each "
                     "generation and runs in one process; a process group runs the "
                     "txt2img configs")
    mesh = make_mesh(["cpu"] if on_cpu else None) if args.mesh else None
    problem = GenerationProblem(config, device=args.device, clip_weights=clip_weights,
                                clip_cfg=clip_cfg, model_cfg=model_cfg, mesh=mesh)
    if args.serve:
        from clip_glass_torch.serving import SearchServer

        if len(targets) > 1:
            print(f"[serve] only the first --target is used (as the idle slots' "
                  f"placeholder); ignoring {len(targets) - 1} more")
        try:
            server = SearchServer(problem, n_slots=args.slots, chunk=args.save_each,
                                  seed=config.seed, search_microbatch=args.search_microbatch,
                                  mesh=mesh)
        except ValueError as e:
            parser.error(f"--serve: {e}")
        return _serve_mode(server, problem, config, args)
    n_search = len(targets)
    if n_search > 1:
        # K searches, one per --target, evaluated as one batch
        try:
            algorithm = make_batched(problem, targets, search_microbatch=args.search_microbatch)
        except ValueError as e:
            parser.error(f"--search-microbatch: {e}")
        rng = algorithm.generators(config.seed)
        folders = [os.path.join(config.tmp_folder, f"search-{i:02d}") for i in range(n_search)]
        for folder, target in zip(folders, targets) if primary else ():
            os.makedirs(folder, exist_ok=True)
            with open(os.path.join(folder, "target.txt"), "w") as f:
                f.write(target)
    else:
        algorithm = problem.make_algorithm()
        rng = algorithm.generator(config.seed)
        folders = [config.tmp_folder]
    phases["setup"] = time.perf_counter() - t0 - sum(phases.values())

    meter = GenerationMeter(config.pop_size * n_search)
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

    def searches(state):
        """(gen, [(X, F) of each search]) of a single or batched state."""
        if n_search == 1:
            return state.gen, [(state.X, state.F)]
        return state.gen[0], list(zip(state.X, state.F))

    @torch.inference_mode()
    def _dump(state):
        gen, pops = searches(state)
        name = (f"genetic-it-{gen}.{ext}" if gen < config.generations
                else f"genetic-it-final.{ext}")
        for folder, (X, F) in zip(folders, pops):
            with Timer() as render:
                if config.n_obj == 1:  # sorted by fitness (reference run.py:36-38)
                    order = fitness_order(F.cpu().numpy())
                    X = X[torch.from_numpy(order).to(X.device)]
                rendered = problem.generator.render(X)
            label = os.path.relpath(os.path.join(folder, name), config.tmp_folder)
            pending.append((label, render.seconds, saver.submit(
                _write, rendered, os.path.join(folder, name))))

    def save_callback(state):
        if primary:   # rank 0 owns the artifact folder
            _dump(state)
        save_state(state, rng, config.tmp_folder, config.name)
        gen = searches(state)[0]
        # the first chunk's wall time holds the kernel builds and the
        # libraries' warm-up: rebaseline there so rates are steady-state
        meter.set_generation(gen, rebaseline=(meter.generation == 0 and gen > 0))
        if verbose and meter.gens_per_sec > 0:
            print(f"  rate: {meter.gens_per_sec:.2f} gen/s "
                  f"({meter.candidates_per_sec:.1f} candidates/s)")

    state = None
    if args.resume:
        try:
            state = load_state(config.tmp_folder, rng)
        except ValueError as e:
            parser.error(f"--resume: {e}")
        want = ((config.pop_size, config.n_var), (config.pop_size, config.n_obj))
        if n_search > 1:
            want = tuple((n_search, *w) for w in want)
        if state is None:
            if primary:
                print("no checkpoint found; starting fresh")
        elif (tuple(state.X.shape), tuple(state.F.shape)) != want:
            parser.error(f"--resume: the checkpoint's X {tuple(state.X.shape)} and F "
                         f"{tuple(state.F.shape)} do not fit this search ({config.name}, "
                         f"pop {config.pop_size})")
    if state is None:
        state = algorithm.init(rng)

    remaining = config.generations - searches(state)[0]
    phases["init(gen0)"] = time.perf_counter() - t0 - sum(phases.values())
    run = minimize if n_search == 1 else minimize_batched
    with ThreadPoolExecutor(max_workers=1) as saver:
        with device_trace(args.profile):
            res = run(algorithm, max(remaining, 0), rng, callback=save_callback,
                      save_each=config.save_each, verbose=verbose, state=state)
        writes = [fut.result() for _, _, fut in pending]  # surface any write error
    phases["search+dumps"] = time.perf_counter() - t0 - sum(phases.values())

    # ---- final artifacts (reference run.py:79-125), one set per search
    for r, folder in zip(res if n_search > 1 else [res], folders) if primary else ():
        _final_artifacts(problem, config, r, folder)
    phases["final_artifacts"] = time.perf_counter() - t0 - sum(phases.values())
    if verbose:
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
