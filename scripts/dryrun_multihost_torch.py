#!/usr/bin/env python
"""Multi-process dry run of the PyTorch port: N processes join one
torch.distributed process group and run the search and the trainer over a
mesh that spans them (clip_glass_torch/parallel; the counterpart of
scripts/dryrun_multihost.py, reference stylegan2/train.py:258-277).

Each rank:
  1. runs the CLI search (`cli.main --distributed SPEC`, what run_torch.py
     runs): StyleGAN2_ffhq_d, TINY models, the mesh implied; rank 0 writes
     the artifact set and ga_state.npz, every rank computes;
  2. runs the data-parallel trainer (TINY, a global batch of 2 a rank) for
     two steps, the first with lazy R1 and path length regularization, each
     rank feeding its slice of the global batch.
Every rank counts the files it opens for writing under the search's folder
(an audit hook). With --device cpu the ranks use gloo on the host; with
--device cuda they share the cards (rank i on card i mod count) through an
explicit gloo backend, which also runs where ranks outnumber the cards.

The launcher starts the ranks, waits (a rank that fails or hangs past
--timeout fails the run) and prints ONE JSON verdict line:
  {"ok": true, "processes": 2, "search_gens": 4, "artifacts": [...], ...}

Usage:
  python scripts/dryrun_multihost_torch.py [--nprocs 2] [--device cpu]
                                           [--generations 4] [--out DIR]
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEARCH = "search"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# ------------------------------------------------------------------ worker

def count_writes(root: str) -> dict:
    """path (relative to root) -> the times this process opened it for
    writing, filled by an audit hook from here on."""
    root = os.path.abspath(root)
    counts = {}

    def hook(event, args):
        if event == "open" and isinstance(args[0], str) and isinstance(args[1], str) \
                and any(c in args[1] for c in "wax+"):
            path = os.path.abspath(args[0])
            if path.startswith(root + os.sep):
                rel = os.path.relpath(path, root)
                counts[rel] = counts.get(rel, 0) + 1

    sys.addaudithook(hook)
    return counts


def worker(args) -> int:
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    from clip_glass_torch.cli import main as cli_main
    from clip_glass_torch.models.stylegan2 import model as sg2
    from clip_glass_torch.parallel import distributed as dist
    from clip_glass_torch.parallel import make_mesh
    from clip_glass_torch.training.trainer import Trainer, TrainerConfig

    torch.set_num_threads(1)
    spec = f"localhost:{args.port},{args.nprocs},{args.proc_id}"
    # the backend is chosen here: gloo lets ranks share the cards
    dist.initialize(spec, backend="gloo", timeout_s=args.timeout)
    rank = dist.rank()
    out = os.path.join(args.out, SEARCH)
    writes = count_writes(out)

    # ---- 1. the CLI search over the mesh (implied by the process group)
    rc = cli_main(["--config", "StyleGAN2_ffhq_d", "--target", "a red flower",
                   "--generations", str(args.generations), "--save-each", "2",
                   "--tmp-folder", out, "--tiny", "--pop-size", "8", "--device", args.device,
                   "--distributed", spec, "--no-verbose"])
    if rc != 0:
        return rc

    # ---- 2. the trainer, each rank feeding its slice of the global batch
    device = "cpu" if args.device == "cpu" else f"cuda:{torch.cuda.current_device()}"
    mesh = make_mesh([device])
    batch = 2 * args.nprocs
    trainer = Trainer(model_cfg=sg2.TINY, mesh=mesh,
                      cfg=TrainerConfig(batch_size=batch, checkpoint_every=0,
                                        g_reg_interval=2, d_reg_interval=2))
    rng = np.random.default_rng(0)   # one stream; each rank keeps its rows
    res = sg2.TINY.resolution

    def batches():
        while True:
            full = rng.uniform(-1, 1, (batch, 3, res, res)).astype(np.float32)
            yield trainer.local_rows(torch.from_numpy(full))

    logs = trainer.train(batches(), iterations=2)
    d_loss = float(logs["d_loss"])

    with open(os.path.join(args.out, f"writes-{rank}.json"), "w") as f:
        json.dump(writes, f)
    dist.barrier()
    if dist.is_primary():
        state = np.load(os.path.join(out, "ga_state.npz"))
        per_rank = []
        for r in range(args.nprocs):
            with open(os.path.join(args.out, f"writes-{r}.json")) as f:
                per_rank.append(json.load(f))
        verdict = {
            "ok": True,
            "processes": dist.world_size(),
            "mesh_size": mesh.size,
            "device": args.device,
            "search_gens": int(state["gen"]),
            "pop_shape": list(state["X"].shape),
            "artifacts": sorted(f for f in os.listdir(out) if not f.endswith(".tmp")),
            "writes_by_rank": per_rank,
            "trainer_steps": int(trainer.state.step),
            "trainer_d_loss": d_loss,
        }
        with open(os.path.join(args.out, "verdict.json"), "w") as f:
            json.dump(verdict, f)
    dist.shutdown()
    return 0


# ---------------------------------------------------------------- launcher

def launch(args) -> int:
    port = _free_port()
    out = args.out or tempfile.mkdtemp(prefix="multihost_torch_dryrun_")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", "--proc-id", str(i),
         "--port", str(port), "--nprocs", str(args.nprocs), "--device", args.device,
         "--generations", str(args.generations), "--timeout", str(args.timeout),
         "--out", out],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(args.nprocs)]
    fail = None
    for i, p in enumerate(procs):
        try:
            outp, _ = p.communicate(timeout=args.timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            outp, _ = p.communicate()
            p.returncode = p.returncode if p.returncode is not None else -9
            outp = f"timed out after {args.timeout} s\n{outp}"
        if p.returncode != 0 and fail is None:
            fail = (i, p.returncode, outp[-2000:])
    if fail is not None:
        for q in procs:
            q.kill()
        print(json.dumps({"ok": False, "proc": fail[0], "rc": fail[1], "tail": fail[2]}))
        return 1
    with open(os.path.join(out, "verdict.json")) as f:
        print(json.dumps(json.load(f)))
    return 0


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--nprocs", type=int, default=2)
    p.add_argument("--device", default="cpu", choices=["cpu", "cuda"])
    p.add_argument("--generations", type=int, default=4)
    p.add_argument("--timeout", type=int, default=600)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--worker", action="store_true")
    p.add_argument("--proc-id", type=int, default=0)
    p.add_argument("--port", type=int, default=0)
    args = p.parse_args()
    return worker(args) if args.worker else launch(args)


if __name__ == "__main__":
    sys.exit(main())
