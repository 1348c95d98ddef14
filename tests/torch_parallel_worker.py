"""One rank of the port's multi-process checks (tests/test_torch_parallel.py).

Each rank joins a gloo process group on the CPU, builds a one-card mesh
(`make_mesh(["cpu"])`, so the mesh spans the ranks) and runs the cases the
test wrote to `--inputs` (torch.save of a dict): the sharded fitness and
two GA generations of the StyleGAN2 `_d` and `_nod` problems, the
data-parallel trainer's cases (each a list of steps with the global
batch's reals and draws, and an optional resume from the last checkpoint),
the dcp checkpoint written by every rank, and `fetch`. Rank 0 saves the
results to `<out>/results.pt`; the trainers' states after every step go
through their rank-0 checkpoints, `<out>/trainer/<case>/step-<n>`.

With `--model-axis 2` the ranks build `make_global_mesh(2)` instead (CLIP
tensor-parallel over model groups of two ranks, tests/test_torch_tp.py) and
run the search cases and `fetch` over its pop axis only.

Run: python tests/torch_parallel_worker.py --rank R --world N --port P \
    --inputs IN.pt --out DIR [--model-axis 2]
"""

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from clip_glass_torch.config import get_config  # noqa: E402
from clip_glass_torch.core.checkpoint import (load_state, load_state_dcp,  # noqa: E402
                                              save_state, save_state_dcp)
from clip_glass_torch.evolve.algorithm import GAState, minimize  # noqa: E402
from clip_glass_torch.fitness.problem import GenerationProblem  # noqa: E402
from clip_glass_torch.models.clip import model as tclip  # noqa: E402
from clip_glass_torch.models.stylegan2 import model as tsg2  # noqa: E402
from clip_glass_torch.parallel import distributed as dist  # noqa: E402
from clip_glass_torch.parallel import make_mesh  # noqa: E402
from clip_glass_torch.training import trainer as ttr  # noqa: E402


def search_config(name: str, pop: int):
    """The TINY problem's config (the tests' too)."""
    return get_config(name).replace(pop_size=pop, dim_z=32, n_var=32, weights="random:0",
                                    target="a red flower", compute_dtype="float32")


def run_search(inp, mesh, out):
    for name, bundle in inp["bundles"].items():
        prob = GenerationProblem(search_config(name, inp["pop"]), device="cpu",
                                 clip_cfg=tclip.TINY, model_cfg=tsg2.TINY, bundle=bundle,
                                 mesh=mesh)
        out[f"{name}/F"] = prob.generator.eval_population(inp["X"])
        res = minimize(prob.make_algorithm(), inp["generations"], inp["seed"])
        out[f"{name}/X_gen"], out[f"{name}/F_gen"] = res.pop_X, res.pop_F


def run_trainer(case, inp, mesh, folder):
    def make():
        return ttr.Trainer(tsg2.TINY, ttr.TrainerConfig(**case["cfg"]), inp["g"], inp["d"],
                           mesh=mesh, device="cpu")

    tr = make()
    logs = []
    for i, (reals, draws) in enumerate(zip(case["reals"], case["draws"])):
        if i == case.get("resume_at"):   # a new trainer from the last checkpoint
            tr = make()
            tr.load_checkpoint(os.path.join(folder, f"step-{i}"))
        step_logs = tr.train_step(tr.local_rows(reals), draws)
        logs.append({k: float(v) for k, v in step_logs.items()})
        tr.save_checkpoint(os.path.join(folder, f"step-{i + 1}"))
    return logs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--model-axis", type=int, default=1)
    args = ap.parse_args()
    torch.set_num_threads(1)
    dist.initialize(f"localhost:{args.port},{args.world},{args.rank}", backend="gloo",
                    timeout_s=120)
    inp = torch.load(args.inputs, weights_only=False)
    block = torch.full((2, 3), float(args.rank))
    if args.model_axis > 1:
        mesh = dist.make_global_mesh(args.model_axis, devices=["cpu"])
        out = {"world": dist.world_size(), "mesh_shape": mesh.shape,
               "fetch": dist.fetch(block, mesh)}
        run_search(inp, mesh, out)
        if dist.is_primary():
            torch.save(out, os.path.join(args.out, "results.pt"))
        dist.barrier()
        dist.shutdown()
        return 0
    mesh = make_mesh(["cpu"])
    out = {"world": dist.world_size(), "mesh_size": mesh.size}
    out["fetch"] = dist.fetch(block)
    run_search(inp, mesh, out)
    for name, case in inp["trainer"].items():
        out[f"trainer/{name}/logs"] = run_trainer(case, inp, mesh,
                                                  os.path.join(args.out, "trainer", name))

    gen = torch.Generator().manual_seed(5)
    state = GAState(inp["X"], out["StyleGAN2_ffhq_d/F"], 3)
    folder = os.path.join(args.out, "ckpt")
    save_state(state, gen, folder, "cfg")
    save_state_dcp(state, gen, folder, "cfg")
    a, b = load_state(folder, torch.Generator()), load_state_dcp(folder, torch.Generator())
    out["ckpt_equal"] = bool(torch.equal(a.X, b.X) and torch.equal(a.F, b.F)
                             and a.gen == b.gen == 3)
    if dist.is_primary():
        torch.save(out, os.path.join(args.out, "results.pt"))
    dist.barrier()
    dist.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
