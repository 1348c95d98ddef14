"""The multi-card dry run: `dryrun_multichip(n)`, the port's counterpart of
the JAX package's `__graft_entry__.dryrun_multichip` (:46-113, :116-345).

Two parts over an n-position mesh, the population on the pop axis and both
CLIP towers tensor-parallel on a model axis of 2 where n allows (n even and
at least 4: the (n / 2, 2) mesh, else (n, 1)):

1. live, TINY models, fp32: one NSGA-II step of StyleGAN2_ffhq_d; then the
   families, each against the unsharded run: BigGAN-deep's mixed genome
   and GPT-2 img2txt (two generations, X within 1e-6, F within rtol 1e-5 /
   atol 1e-6), a pop-64 step through eval_microbatch 16, K searches
   batched (F rtol 2e-3: the evaluation batches differ) and the server over
   the mesh with more requests than slots;
2. full size, from shapes alone (`weights="abstract"`, `Trainer(abstract=
   True)`, on `parallel.mesh.abstract_mesh`: one rank's share, no process
   group): the config-f 1024 px flagship evaluation at pop 16, bf16;
   DeepMindBigGAN512 at pop 256 through eval_microbatch 32, bf16; the
   config-f 1024 px training step at batch max(8, n), fp32, both
   regularizers. Each rank's bytes (`evaluation_bytes`, `train_step_bytes`:
   what it holds, plus the peak of what the work allocates,
   core.memory.PeakMemory, each storage in the caching allocator's blocks,
   plus WORKSPACE_BYTES for what no op's output shows) must be below
   `budget_bytes`, the card's memory by default.

The JAX check compiles the whole GA step; here the survival needs values
(the non-dominated sort, the duplicate resampling), so the full-size part
sizes the evaluation and the training step, which hold the memory.

On the card the mesh lists the cards in turn (several positions a card
when n exceeds them: one process, one thread a position); `device="cpu"`
runs the live part on the host.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from clip_glass_torch.core import memory
from clip_glass_torch.core.device import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DOG = os.path.join(ROOT, "examples", "gpt2_images", "dog.jpeg")


# What the tracker cannot see, by kind of work: the workspaces that cuBLAS
# (32 MiB a handle, and a step's backward runs on a thread with a handle of
# its own) and cuDNN take from the caching allocator outside any op's
# output, and the large blocks the allocator hands out unsplit (up to 1 MiB
# above the request). A margin above what chip_smoke.py phase 30 (c)
# measures on the card (`untracked_bytes`: the allocated peak less the
# tracker's requested bytes on the same run, cuBLAS's workspaces made
# within it, cuDNN's TF32 off and allowed): some 46 MB for the flagship
# evaluation, and for the config-f regularized step up to 1.6 GB, nearly
# all cuDNN's workspaces for the double backward of R1 and the path length
# penalty. PERF.md, section 6, has the readings.
WORKSPACE_BYTES = {"evaluation": 128 * 2 ** 20, "train_step": 2 * 2 ** 30}


def model_axis_for(n: int) -> int:
    """The JAX dry run's split: a model axis of 2 when n is even and >= 4."""
    return 2 if n % 2 == 0 and n >= 4 else 1


# ------------------------------------------------------------ estimates

def evaluation_bytes(config, mesh=None, clip_cfg=None, model_cfg=None) -> dict:
    """One rank's bytes for `eval_population` of a [pop, n_var] population
    of `config` at full size (its weights made abstract), on `mesh` (an
    `abstract_mesh`, or None for one process): `resident` (the weights as
    the rank holds them, CLIP's model shard on a 2-D mesh, the target and
    the population), `work_peak` (the evaluation's allocations at their
    peak), `workspace` (WORKSPACE_BYTES) and `total`, each as the caching
    allocator's blocks hold them; `requested`: resident and work peak as
    requested."""
    from clip_glass_torch.fitness.problem import GenerationProblem

    gen = GenerationProblem(config.replace(weights="abstract"), clip_weights="abstract",
                            clip_cfg=clip_cfg, model_cfg=model_cfg, mesh=mesh).generator
    X = torch.empty((config.pop_size, config.n_var), device=memory.META)
    return _estimate([gen.bundle, X], lambda: _check_F(gen.eval_population(X), config),
                     "evaluation")


def _check_F(F, config) -> None:
    if tuple(F.shape) != (config.pop_size, config.n_obj):
        raise AssertionError(f"abstract F {tuple(F.shape)}")


def _estimate(resident_tree, work, kind: str) -> dict:
    """The bytes of `resident_tree` as it stands before `work()` runs, the
    peak of what `work()` allocates, and the workspace margin of `kind`."""
    resident = memory.tree_bytes(resident_tree)
    asked = memory.tree_bytes(resident_tree, requested=True)
    with memory.PeakMemory() as m:
        work()
    ws = WORKSPACE_BYTES[kind]
    return {"resident": resident, "work_peak": m.peak, "workspace": ws,
            "total": resident + m.peak + ws, "requested": asked + m.requested_peak}


def train_step_bytes(model_cfg, batch: int, mesh=None, trainer_cfg=None) -> dict:
    """One rank's bytes for a regularized training step (R1 and the path
    length penalty: step 0) at `batch` global rows, fp32, on `mesh` (an
    `abstract_mesh` of n positions: its batch / n rows, or None):
    `resident` (G, D, Gs, both Adams, pl_avg and the rank's reals),
    `work_peak`, `workspace`, `total` and `requested`, as
    `evaluation_bytes`'s."""
    from clip_glass_torch.training.trainer import Trainer, TrainerConfig

    cfg = dataclasses.replace(trainer_cfg or TrainerConfig(), batch_size=batch,
                              checkpoint_every=0)
    tr = Trainer(model_cfg, cfg, mesh=mesh, abstract=True)
    n = mesh.size if mesh is not None else 1
    if batch % n:
        raise ValueError(f"batch {batch} does not split over {n} ranks")
    res = model_cfg.resolution
    reals = torch.empty((batch // n, model_cfg.data_channels, res, res), device=memory.META)
    return _estimate([list(tr.state[:6]), reals], lambda: tr.train_step(reals), "train_step")


def fullsize_estimates(n: int) -> dict:
    """Each full-size step's bytes on one rank of an n-position abstract
    mesh (a model axis by `model_axis_for`)."""
    from clip_glass_torch.config import get_config
    from clip_glass_torch.models.stylegan2 import model as sg2
    from clip_glass_torch.parallel.mesh import abstract_mesh

    tp = model_axis_for(n)
    flagship = get_config("StyleGAN2_ffhq_d").replace(
        target="the face of a man with brown eyes", pop_size=16, compute_dtype="bfloat16")
    biggan = get_config("DeepMindBigGAN512").replace(
        target="a wolf at night", pop_size=256, eval_microbatch=32, compute_dtype="bfloat16")
    batch = max(8, n)
    return {
        "mesh": {"pop": n // tp, "model": tp},
        "flagship_pop16_bf16": evaluation_bytes(flagship, abstract_mesh(n, tp)),
        "biggan512_pop256_mb32_bf16": evaluation_bytes(biggan, abstract_mesh(n, tp)),
        f"train_config_f_batch{batch}_fp32": {
            **train_step_bytes(sg2.CONFIG_F, batch, abstract_mesh(n)), "ranks": n},
    }


# ------------------------------------------------------------ the live part

def _tiny(name: str, **kw):
    from clip_glass_torch.config import get_config

    return get_config(name).replace(**{**dict(
        pop_size=8, dim_z=32, n_var=32, weights="random:0", target="a red flower",
        compute_dtype="float32"), **kw})


def _problem(config, model_cfg, device, mesh=None):
    from clip_glass_torch.fitness.problem import GenerationProblem
    from clip_glass_torch.models.clip import model as clip_model

    return GenerationProblem(config, device=device, clip_cfg=clip_model.TINY,
                             model_cfg=model_cfg, mesh=mesh)


def _same(label: str, got, want, f_rtol: float = 1e-5, f_atol: float = 1e-6) -> None:
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(), rtol=1e-6,
                               atol=1e-6, err_msg=f"{label}: X")
    np.testing.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(), rtol=f_rtol,
                               atol=f_atol, err_msg=f"{label}: F")


def _two_generations(problem, seed: int):
    from clip_glass_torch.evolve.algorithm import minimize

    r = minimize(problem.make_algorithm(), 2, seed)
    return r.pop_X, r.pop_F


def live_checks(mesh, device) -> dict:
    """The live part on `mesh` (TINY, fp32); raises on a mismatch."""
    from clip_glass_torch.evolve.algorithm import minimize
    from clip_glass_torch.evolve.batched import make_batched, minimize_batched
    from clip_glass_torch.models.biggan import model as bg
    from clip_glass_torch.models.gpt2 import model as g2
    from clip_glass_torch.models.stylegan2 import model as sg2
    from clip_glass_torch.serving import SearchServer

    out = {}
    pop = max(8, 2 * mesh.dp)
    prob = _problem(_tiny("StyleGAN2_ffhq_d", pop_size=pop), sg2.TINY, device, mesh)
    res = minimize(prob.make_algorithm(), 1, 0)
    if tuple(res.pop_X.shape) != (pop, 32) or not torch.isfinite(res.pop_F).all():
        raise AssertionError(f"NSGA-II step: X {tuple(res.pop_X.shape)}")
    out["nsga2_step"] = {"pop": pop}

    for label, config, model_cfg, seed in (
            ("StyleGAN2_ffhq_d", _tiny("StyleGAN2_ffhq_d"), sg2.TINY, 9),
            ("biggan_mixed_genome", _tiny("DeepMindBigGAN256", batch_size=8, dim_z=16,
                                          num_classes=10, n_var=26, resolution=8),
             bg.TINY, 2),
            ("gpt2_img2txt", _tiny("GPT2", batch_size=8, dim_z=6, n_var=6,
                                   max_tokens_len=5, target=DOG), g2.TINY, 3)):
        want = _two_generations(_problem(config, model_cfg, device), seed)
        _same(label, _two_generations(_problem(config, model_cfg, device, mesh), seed), want)
        out[label] = "equal"

    config = _tiny("StyleGAN2_ffhq_d", pop_size=64, eval_microbatch=16)
    res = minimize(_problem(config, sg2.TINY, device, mesh).make_algorithm(), 1, 5)
    if tuple(res.pop_X.shape) != (64, 32) or not torch.isfinite(res.pop_F).all():
        raise AssertionError("the microbatched step")
    out["microbatch"] = {"pop": 64, "eval_microbatch": 16}

    K = max(2, mesh.dp)
    targets = [f"a portrait, variant {i}" for i in range(K)]
    single, meshed = (_problem(_tiny("StyleGAN2_ffhq_d"), sg2.TINY, device, m)
                      for m in (None, mesh))
    want = minimize_batched(make_batched(single, targets), 2, 8)
    got = minimize_batched(make_batched(meshed, targets), 2, 8)
    for i, (g, w) in enumerate(zip(got, want)):
        _same(f"batched search {i}", (g.pop_X, g.pop_F), (w.pop_X, w.pop_F), f_rtol=2e-3,
              f_atol=1e-5)
    out["batched"] = {"searches": K}

    server = SearchServer(meshed, n_slots=mesh.dp, chunk=2, seed=5, mesh=mesh)
    tickets = [server.submit(f"mesh serve {i}", n_gen=2) for i in range(mesh.dp + 2)]
    server.run()
    if server.stats.completed != len(tickets) or not all(
            torch.isfinite(server.results[t].pop_F).all() for t in tickets):
        raise AssertionError(f"serving: {server.stats.completed} of {len(tickets)}")
    out["serving"] = {"slots": mesh.dp, "requests": len(tickets)}
    return out


def dryrun_multichip(n: int, budget_bytes: Optional[int] = None, device=None,
                     full_size: bool = True) -> dict:
    """Both parts over an n-position mesh (module docstring); raises on a
    mismatch or when a rank's full-size footprint reaches `budget_bytes`
    (default: the card's memory, `torch.cuda.mem_get_info`; required
    without a card). Returns the live records and the estimates."""
    from clip_glass_torch.parallel.mesh import make_mesh

    if budget_bytes is None:
        if not torch.cuda.is_available():
            raise ValueError("budget_bytes is required without a card")
        budget_bytes = torch.cuda.mem_get_info()[1]
    if resolve_device(device).type == "cpu":
        devices = ["cpu"] * n
    else:   # the cards in turn
        devices = [torch.device("cuda", i % torch.cuda.device_count()) for i in range(n)]
    mesh = make_mesh(devices, model_axis_size=model_axis_for(n))
    out = {"mesh": {"pop": mesh.dp, "model": mesh.tp}, "budget_bytes": int(budget_bytes),
           "live": live_checks(mesh, mesh.device)}
    if full_size:
        est = fullsize_estimates(n)
        over = {k: v["total"] for k, v in est.items() if k != "mesh" and
                not v["total"] < budget_bytes}
        if over:
            raise AssertionError(f"full-size steps over the budget of {budget_bytes} bytes a "
                                 f"rank: {over}")
        out["fullsize"] = est
    return out
