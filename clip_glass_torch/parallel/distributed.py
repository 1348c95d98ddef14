"""Multi-process runs on torch.distributed: the rendezvous, and the host-side
reads of row-split tensors.

The reference trainer runs one process per GPU rank (reference
stylegan2/train.py:258-277: MASTER_ADDR / MASTER_PORT, then an NCCL process
group). This port keeps that layout: one process per card, joined by one
default process group; a process may also drive several cards of its own
(`parallel.mesh`). Every rank holds the GA state whole and draws the same
variation, so only the evaluation is split; its row blocks come back whole
on every rank through `fetch`.

`is_primary()` gates file writes to rank 0; every rank still computes and
reaches the same collectives in the same order (the reference's rank-0
checkpointing, train.py:560-575).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

ENV_SPEC = "CGT_DISTRIBUTED"
# a rank left waiting at a collective fails after this long instead of hanging
DEFAULT_TIMEOUT_S = 600.0
TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def parse_spec(spec: str):
    """(init_method, world_size, rank, local_rank) of a spec string:
    "auto" reads torchrun's variables (env://), "<host:port>,<num>,<id>"
    names the rendezvous (tcp://; the local rank is LOCAL_RANK when set,
    else the process id). Raises ValueError for anything else."""
    env = os.environ
    if spec == "auto":
        missing = [k for k in TORCHRUN_VARS if k not in env]
        if missing:
            raise ValueError(f"distributed spec 'auto' reads torchrun's variables; "
                             f"{', '.join(missing)} not set")
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
        return "env://", world, rank, int(env.get("LOCAL_RANK", rank))
    parts = spec.split(",")
    try:
        if len(parts) != 3 or ":" not in parts[0]:
            raise ValueError
        host, port = parts[0].rsplit(":", 1)
        world, rank = int(parts[1]), int(parts[2])
        int(port)
    except ValueError:
        raise ValueError(f"distributed spec {spec!r}: expected 'auto' or "
                         "'<host:port>,<num_processes>,<process_id>'") from None
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"distributed spec {spec!r}: process id {rank} is not in "
                         f"[0, {world})")
    return f"tcp://{host}:{port}", world, rank, int(env.get("LOCAL_RANK", rank))


def initialize(spec: Optional[str] = None, backend: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the default process group that `spec` names (the CLI's
    `--distributed`, else the CGT_DISTRIBUTED variable): "auto" (torchrun),
    "<host:port>,<num>,<id>", or None / "" for one process (a no-op that
    returns False). Idempotent: once a group exists, returns True.

    The backend is NCCL when the host has cards and gloo without; the rank
    takes the card LOCAL_RANK names (`torch.cuda.set_device`, before any
    CUDA use). Under NCCL a local rank beyond the host's cards raises: NCCL
    takes one rank a card. An explicit `backend="gloo"` lets ranks share the
    cards (local rank modulo their count); gloo moves CUDA tensors through
    the host."""
    if dist.is_initialized():
        return True
    spec = spec if spec is not None else os.environ.get(ENV_SPEC, "")
    if not spec:
        return False
    init_method, world, rank, local_rank = parse_spec(spec)
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    backend = backend or ("nccl" if n_cards else "gloo")
    if backend == "nccl":
        if local_rank >= n_cards:
            raise RuntimeError(
                f"local rank {local_rank} has no card of its own ({n_cards} on this "
                "host) and NCCL takes one rank a card; pass backend='gloo' to share them")
        torch.cuda.set_device(local_rank)
    elif n_cards:
        torch.cuda.set_device(local_rank % n_cards)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def shutdown() -> None:
    """Leave the process group (no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def active() -> bool:
    """True when the run spans more than one process."""
    return world_size() > 1


def is_primary() -> bool:
    """Rank 0 owns the files (checkpoints, dumps, results); every rank
    computes and reaches the same collectives in the same order."""
    return rank() == 0


def barrier() -> None:
    """Wait for every rank (no-op in one process)."""
    if active():
        dist.barrier()


def fetch(x: torch.Tensor) -> torch.Tensor:
    """This rank's row block -> the whole tensor, rank blocks in rank order,
    on every rank and on x's device (an all_gather; every rank's block has
    x's shape). One process: x itself."""
    if not active():
        return x
    parts = [torch.empty_like(x) for _ in range(world_size())]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


def fetch_tree(tree):
    """`fetch` over the tensors of a dict / list / tuple tree."""
    if isinstance(tree, dict):
        return {k: fetch_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(fetch_tree(v) for v in tree)
    return fetch(tree) if isinstance(tree, torch.Tensor) else tree


def make_global_mesh(model_axis_size: int = 1, pop_axis: str = "pop",
                     model_axis: str = "model", devices=None):
    """The mesh over every rank's cards with the population on its one
    axis (`parallel.mesh.make_mesh`). A CLIP model axis
    (`model_axis_size` > 1) is ROADMAP item 16b and raises."""
    from clip_glass_torch.parallel.mesh import make_mesh

    if model_axis_size != 1:
        raise NotImplementedError(
            f"a {model_axis!r} axis of {model_axis_size} (CLIP tensor parallelism) is "
            "ROADMAP item 16b")
    return make_mesh(devices, axis=pop_axis)


def global_batch_from_local(mesh, local_batch, axis=None) -> torch.Tensor:
    """This rank's slice of the global batch (each rank's data iterator
    yields its own, as the reference's per-rank DataLoader, train.py:465),
    on the rank's card. A rank holds only its own rows: the global batch is
    the ranks' slices in rank order. `axis`, a mesh axis name or a tuple of
    them, must name the mesh's batch axis."""
    names = (tuple(axis) if isinstance(axis, (tuple, list))
             else (axis,) if axis is not None else mesh.axis_names)
    if not set(names) <= set(mesh.axis_names):
        raise ValueError(f"batch axes {names} are not axes of the mesh {mesh.axis_names}")
    return torch.as_tensor(local_batch).to(mesh.device)
