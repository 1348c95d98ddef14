"""The mesh: this process's cards crossed with the process group, and
population sharding over it.

The JAX package shards the GA's population axis over a 1-D device mesh and
lets GSPMD split the evaluation (clip_glass_tpu/parallel/mesh.py). Here a
`Mesh` lists the cards this process drives; with a process group the mesh
spans every rank's cards, rank-major. The population splits into contiguous
row blocks, one a card: rank r's card i evaluates block r * n_local + i.
The GA state stays whole and replicated on every rank (every rank draws the
same variation), so a generation moves only its fitness rows between ranks
(`distributed.fetch`) and, where D pools rows of several cards, the
minibatch-std input (`gather_rows`).

A process with several cards drives each from a thread of its own
(`Mesh.map`, as torch.nn.DataParallel's parallel_apply does), with that
card current: eager launches on one card then do not wait for another's.
The threads meet in `gather_rows`.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from clip_glass_torch.core.device import resolve_device
from clip_glass_torch.parallel import distributed as cg_dist

POP_AXIS = "pop"

# the local shard a thread computes (`Mesh.map`): .index and .exchange
_shard = threading.local()


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """`devices`: this process's cards; `world` / `rank`: the process group's
    size and this process's rank (1 / 0 without one). One axis, the
    population's (or the batch's: its name is only a label)."""
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = (POP_AXIS,)
    world: int = 1
    rank: int = 0

    @property
    def local_size(self) -> int:
        return len(self.devices)

    @property
    def size(self) -> int:
        """Shards over all ranks: world x local cards."""
        return self.world * len(self.devices)

    @property
    def device(self) -> torch.device:
        """The process's first card: where whole tensors (the GA state) live."""
        return self.devices[0]

    def shard_index(self) -> int:
        """The mesh position of the shard the calling thread computes."""
        return self.rank * self.local_size + (getattr(_shard, "index", None) or 0)

    def map(self, fn: Callable, blocks: Sequence) -> List:
        """[fn(i, block_i)] for each local card i, each with its card
        current and with the caller's grad mode; one thread a card when the
        process has several, which meet in `gather_rows`. The first error of
        any shard is raised here (the others are released from their wait)."""
        if self.local_size == 1:
            return [_call(self, 0, None, fn, blocks[0])]
        ex = _Exchange(self.local_size)
        out, errors = [None] * self.local_size, []
        grad, inference = torch.is_grad_enabled(), torch.is_inference_mode_enabled()

        def run(i):
            try:
                with torch.inference_mode(inference), torch.set_grad_enabled(grad):
                    out[i] = _call(self, i, ex, fn, blocks[i])
            except BaseException as e:  # noqa: BLE001 - re-raised by the caller
                errors.append(e)
                ex.barrier.abort()

        threads = [threading.Thread(target=run, args=(i,), daemon=True)
                   for i in range(self.local_size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            first = next((e for e in errors if not isinstance(e, threading.BrokenBarrierError)),
                         errors[0])
            raise first
        return out


def _call(mesh: Mesh, i: int, ex, fn, block):
    prev = (getattr(_shard, "index", None), getattr(_shard, "exchange", None))
    _shard.index, _shard.exchange = i, ex
    try:
        dev = mesh.devices[i]
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                return fn(i, block)
        return fn(i, block)
    finally:
        _shard.index, _shard.exchange = prev


class _Exchange:
    """The meeting point of one process's shard threads in `gather_rows`."""

    def __init__(self, n: int):
        self.barrier = threading.Barrier(n)
        self.slots: List[Optional[torch.Tensor]] = [None] * n
        self.result: Optional[torch.Tensor] = None

    def gather(self, i: int, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        self.slots[i] = x
        self.barrier.wait()
        if i == 0:   # one thread speaks for the process to the other ranks
            self.result = _gather_ranks(torch.cat([s.to(x.device) for s in self.slots]),
                                        mesh)
        self.barrier.wait()
        out = self.result.to(x.device)
        self.barrier.wait()   # nobody refills the slots before all have read
        return out


def make_mesh(devices: Optional[Sequence] = None, axis: str = POP_AXIS) -> Mesh:
    """A mesh of `devices` (names or torch.devices; ["cpu", "cpu"] splits
    the population in two on the host) crossed with the process group.
    Default: every visible card, or under a process group this rank's own
    card (one process a card, the reference's layout). Raises without a card
    unless the devices are given."""
    if devices is None:
        resolve_device("cuda")
        devices = ([torch.cuda.current_device()] if cg_dist.active()
                   else range(torch.cuda.device_count()))
        devices = [torch.device("cuda", int(d)) for d in devices]
    devs = tuple(resolve_device(d) for d in devices)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    devs = tuple(torch.device("cuda", torch.cuda.current_device())
                 if d.type == "cuda" and d.index is None else d for d in devs)
    return Mesh(devs, (axis,), cg_dist.world_size(), cg_dist.rank())


@dataclasses.dataclass(frozen=True)
class RowSharding:
    """Rows of [n, ...] tensors in contiguous blocks over the mesh, rank
    first, then this process's cards."""
    mesh: Mesh

    def slices(self, n: int) -> List[slice]:
        """This process's blocks of n rows, one a local card."""
        m = self.mesh
        if n % m.size:
            raise ValueError(f"{n} rows do not split over the mesh's {m.size} shards")
        b = n // m.size
        first = m.rank * m.local_size
        return [slice((first + i) * b, (first + i + 1) * b) for i in range(m.local_size)]

    def split(self, x: torch.Tensor) -> List[torch.Tensor]:
        """This process's blocks of x, each on its card."""
        return [x[s].to(d) for s, d in zip(self.slices(x.shape[0]), self.mesh.devices)]

    def gather(self, blocks: Sequence[torch.Tensor]) -> torch.Tensor:
        """The blocks of every shard, whole on every rank, on the mesh's
        first card."""
        local = torch.cat([b.to(self.mesh.device) for b in blocks])
        return cg_dist.fetch(local)


@dataclasses.dataclass(frozen=True)
class Replicated:
    """Every shard holds the whole value."""
    mesh: Mesh

    def place(self, x: torch.Tensor) -> List[torch.Tensor]:
        return [x.to(d) for d in self.mesh.devices]


def population_sharding(mesh: Mesh, axis: str = POP_AXIS) -> RowSharding:
    """Rows of [pop, ...] tensors split across the mesh."""
    if axis not in mesh.axis_names:
        raise ValueError(f"axis {axis!r} is not an axis of the mesh {mesh.axis_names}")
    return RowSharding(mesh)


def replicated_sharding(mesh: Mesh) -> Replicated:
    return Replicated(mesh)


def shard_state(state, mesh: Mesh):
    """A GAState placed for a run over `mesh`: whole and replicated, on the
    mesh's first card, on every rank. Every rank advances it identically,
    so only the evaluation is split (the JAX package's state is global
    too)."""
    return type(state)(X=state.X.to(mesh.device), F=state.F.to(mesh.device), gen=state.gen)


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks; its gradient is the same sum of the ranks' gradients
    (the loss is the sum of the ranks' losses), and that gradient is itself
    differentiable (a second derivative goes through it again)."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g)


class _AllGatherRows(torch.autograd.Function):
    """The ranks' equal row blocks concatenated in rank order on every rank.
    Rank r's block feeds every rank's loss, so its gradient is the sum over
    ranks of the gathered gradient's block r: an all_reduce, differentiable,
    so that R1 and the path length penalty differentiate through it twice.
    Every rank reaches each gather, forward and backward, in one order."""

    @staticmethod
    def forward(ctx, x):
        ctx.rows = x.shape[0]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank()
        return _AllReduceSum.apply(g.contiguous())[r * ctx.rows:(r + 1) * ctx.rows]


def _gather_ranks(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _AllGatherRows.apply(x) if mesh.world > 1 else x


def all_reduce_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Sum of x over the mesh's ranks, differentiable (x itself without a
    process group)."""
    if mesh is None or mesh.world == 1:
        return x
    return _AllReduceSum.apply(x)


def gather_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Every shard's equal row block of a row-split tensor, whole, in mesh
    order, on x's device: a torch.cat across this process's cards (whose
    threads meet here) and an all_gather across ranks, differentiable
    across ranks. Several cards in one process serve evaluation only:
    their threads do not share a backward pass."""
    if mesh is None or mesh.size == 1:
        return x
    if mesh.local_size == 1:
        return _gather_ranks(x, mesh)
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError("a gradient through several cards of one process: "
                                  "run one process a card")
    ex = getattr(_shard, "exchange", None)
    if ex is None:
        raise RuntimeError("gather_rows over several cards of one process runs "
                           "inside Mesh.map")
    return ex.gather(_shard.index, x, mesh)


def own_rows(full: torch.Tensor, rows: int, mesh: Mesh) -> torch.Tensor:
    """The calling shard's block of `rows` rows of a gathered tensor."""
    k = mesh.shard_index()
    return full[k * rows:(k + 1) * rows]
