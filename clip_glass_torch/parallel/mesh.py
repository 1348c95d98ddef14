"""The mesh: this process's cards crossed with the process group, population
sharding over it, and CLIP tensor parallelism on its model axis.

The JAX package shards the GA's population axis over a device mesh and lets
GSPMD split the evaluation (clip_glass_tpu/parallel/mesh.py). Here a `Mesh`
lists the cards this process drives; with a process group the mesh spans
every rank's cards, rank-major. Its positions are numbered rank * n_local +
card. A 1-D mesh has the one axis "pop": the population splits into
contiguous row blocks, one a position. A 2-D mesh has the axes ("pop",
"model") with the shape (dp, tp), the model axis inner: a model group is tp
consecutive positions. The rows split over the pop axis only, every
position of a model group holds its group's row block, and CLIP's towers
split over the model axis Megatron style (`shard_clip_tp`): each position
holds its heads and MLP columns, and the partial products of the two
output projections of a block are summed over the group (`model_sum`).
G and D run replicated within a group on the group's rows, as GSPMD runs
them.

A model group is either tp local cards of one process (their threads meet
in an exchange) or tp consecutive ranks of one host with one card each,
joined by a `dist.new_group`; the model axis never spans hosts (the JAX
rule, clip_glass_tpu/parallel/distributed.py:126-131). The GA state stays
whole and replicated on every rank (every rank draws the same variation),
so a generation moves only its fitness rows between ranks
(`distributed.fetch`, over the pop axis) and, where D pools rows of several
row blocks, the minibatch-std input (`gather_rows`, over the pop axis).

A process with several cards drives each from a thread of its own
(`Mesh.map`, as torch.nn.DataParallel's parallel_apply does), with that
card current: eager launches on one card then do not wait for another's.

`abstract_mesh(n)` describes one rank of an n-position mesh with no process
group, on the `meta` device: its collectives allocate their outputs and
move nothing, so one rank's footprint is estimated from shapes alone
(parallel/dryrun.py).
"""

from __future__ import annotations

import dataclasses
import socket
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from clip_glass_torch.core.device import resolve_device
from clip_glass_torch.parallel import distributed as cg_dist

POP_AXIS = "pop"
MODEL_AXIS = "model"

# the local shard a thread computes (`Mesh.map`): .mesh, .index, .exchange
# and .model_exchange
_shard = threading.local()


@dataclasses.dataclass(frozen=True)
class RankGroups:
    """The process groups of a model axis that spans ranks: this rank's
    model group (tp consecutive ranks) and its pop group (the ranks of its
    model index, one a model group)."""
    model: object
    pop: object


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """`devices`: this process's cards; `world` / `rank`: the process group's
    size and this process's rank (1 / 0 without one); `tp`: the model
    axis's extent (1: a 1-D mesh, the population's or the batch's axis, its
    name only a label); `groups`: the process groups of a model axis that
    spans ranks."""
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = (POP_AXIS,)
    world: int = 1
    rank: int = 0
    tp: int = 1
    groups: Optional[RankGroups] = None

    @property
    def local_size(self) -> int:
        return len(self.devices)

    @property
    def size(self) -> int:
        """Positions over all ranks: world x local cards."""
        return self.world * len(self.devices)

    @property
    def dp(self) -> int:
        """The pop axis's extent: the row blocks a batch splits into."""
        return self.size // self.tp

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.dp, self.tp) if len(self.axis_names) == 2 else (self.size,)

    @property
    def device(self) -> torch.device:
        """The process's first card: where whole tensors (the GA state) live."""
        return self.devices[0]

    @property
    def abstract(self) -> bool:
        """A mesh of shapes alone (`abstract_mesh`)."""
        return self.device.type == "meta"

    @property
    def model_spans_ranks(self) -> bool:
        """Whether a model group is several ranks (one card each)."""
        return self.tp > self.local_size

    @property
    def pop_ranks(self) -> int:
        """The ranks a gather over the pop axis takes a block from: every
        rank, or under a rank-spanning model axis one a model group."""
        return self.world // self.tp if self.model_spans_ranks else self.world

    @property
    def pop_rank(self) -> int:
        """This rank's place among `pop_ranks`."""
        return self.rank // self.tp if self.model_spans_ranks else self.rank

    @property
    def pop_group(self):
        """The process group of a gather over the pop axis (None: the
        default group)."""
        return self.groups.pop if self.groups is not None else None

    def position(self, i: int) -> int:
        """The mesh position of local card i."""
        return self.rank * self.local_size + i

    def pop_index(self, i: int) -> int:
        """The row block local card i computes."""
        return self.position(i) // self.tp

    def model_index(self, i: int) -> int:
        """Local card i's place in its model group: which CLIP shard it holds."""
        return self.position(i) % self.tp

    def map(self, fn: Callable, blocks: Sequence) -> List:
        """[fn(i, block_i)] for each local card i, each with its card
        current and with the caller's grad mode; one thread a card when the
        process has several, which meet in `gather_rows` and `model_sum`.
        The first error of any shard is raised here (the others are released
        from their wait)."""
        if self.local_size == 1:
            return [_call(self, 0, None, None, fn, blocks[0])]
        ex = _Exchange(self.local_size)
        groups = [_Exchange(self.tp) for _ in range(self.local_size // self.tp)]
        out, errors = [None] * self.local_size, []
        grad, inference = torch.is_grad_enabled(), torch.is_inference_mode_enabled()

        def run(i):
            try:
                with torch.inference_mode(inference), torch.set_grad_enabled(grad):
                    out[i] = _call(self, i, ex, groups[i // self.tp], fn, blocks[i])
            except BaseException as e:  # noqa: BLE001 - re-raised by the caller
                errors.append(e)
                for x in (ex, *groups):
                    x.barrier.abort()

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


def _call(mesh: Mesh, i: int, ex, model_ex, fn, block):
    names = ("mesh", "index", "exchange", "model_exchange")
    prev = tuple(getattr(_shard, k, None) for k in names)
    for k, v in zip(names, (mesh, i, ex, model_ex)):
        setattr(_shard, k, v)
    try:
        dev = mesh.devices[i]
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                return fn(i, block)
        return fn(i, block)
    finally:
        for k, v in zip(names, prev):
            setattr(_shard, k, v)


class _Exchange:
    """The meeting point of a process's shard threads: `gather_rows` (all
    local cards) and `model_sum` (one model group's)."""

    def __init__(self, n: int):
        self.barrier = threading.Barrier(n)
        self.slots: List[Optional[torch.Tensor]] = [None] * n
        self.result: Optional[torch.Tensor] = None

    def gather(self, i: int, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        self.slots[i] = x
        self.barrier.wait()
        if i == 0:   # one thread speaks for the process to the other ranks
            # one block a model group: its positions hold the same rows
            self.result = _gather_ranks(torch.cat([s.to(x.device) for s in self.slots[::mesh.tp]]),
                                        mesh)
        self.barrier.wait()
        out = self.result.to(x.device)
        self.barrier.wait()   # nobody refills the slots before all have read
        return out

    def sum(self, j: int, x: torch.Tensor) -> torch.Tensor:
        self.slots[j] = x
        self.barrier.wait()
        out = self.slots[0].to(x.device)
        for s in self.slots[1:]:   # one order on every thread: equal sums
            out = out + s.to(x.device)
        self.barrier.wait()
        return out


def _same_host(world: int) -> bool:
    names = [None] * world
    dist.all_gather_object(names, socket.gethostname())
    return len(set(names)) == 1


def _rank_groups(world: int, rank: int, tp: int) -> RankGroups:
    """Every rank creates every group, in one order: the model groups, then
    the pop groups."""
    model = pop = None
    for g in range(world // tp):
        group = dist.new_group(list(range(g * tp, (g + 1) * tp)))
        if rank // tp == g:
            model = group
    for j in range(tp):
        group = dist.new_group(list(range(j, world, tp)))
        if rank % tp == j:
            pop = group
    return RankGroups(model, pop)


def make_mesh(devices: Optional[Sequence] = None, axis: str = POP_AXIS,
              model_axis_size: int = 1, model_axis: str = MODEL_AXIS) -> Mesh:
    """A mesh of `devices` (names or torch.devices; ["cpu", "cpu"] splits
    the population in two on the host) crossed with the process group.
    Default: every visible card, or under a process group this rank's own
    card (one process a card, the reference's layout). Raises without a card
    unless the devices are given.

    `model_axis_size` = tp > 1 gives the 2-D mesh (axis, model_axis) of
    shape (positions / tp, tp): tp must divide this process's cards, or,
    with one card a process, the world, whose tp consecutive ranks must
    then share a host (every rank builds the mesh: it creates the groups)."""
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
    world, rank, tp = cg_dist.world_size(), cg_dist.rank(), int(model_axis_size)
    if tp == 1:
        return Mesh(devs, (axis,), world, rank)
    if tp < 1:
        raise ValueError(f"model_axis_size {tp}")
    groups = None
    if len(devs) % tp:
        if len(devs) != 1 or world % tp:
            raise ValueError(
                f"model_axis_size {tp} must divide the process's {len(devs)} cards, or "
                f"with one card a process the {world} ranks")
        if not _same_host(world):
            raise ValueError(f"model_axis_size {tp}: the model axis must not span hosts "
                             "(its two all-reduces a block belong on the host's links)")
        groups = _rank_groups(world, rank, tp)
    return Mesh(devs, (axis, model_axis), world, rank, tp, groups)


def abstract_mesh(n: int, model_axis_size: int = 1) -> Mesh:
    """Rank 0 of an n-position mesh (one card a rank; a 2-D (n / tp, tp)
    mesh when `model_axis_size` = tp > 1) on the `meta` device, with no
    process group: a computation on it runs the first position's share at
    its real shapes, and every collective allocates its output and moves
    nothing."""
    if n % model_axis_size:
        raise ValueError(f"model_axis_size {model_axis_size} does not divide {n}")
    names = (POP_AXIS,) if model_axis_size == 1 else (POP_AXIS, MODEL_AXIS)
    return Mesh((torch.device("meta"),), names, n, 0, model_axis_size)


@dataclasses.dataclass(frozen=True)
class RowSharding:
    """Rows of [n, ...] tensors in contiguous blocks over the mesh's pop
    axis, rank first, then this process's cards; the positions of a model
    group hold the same block."""
    mesh: Mesh

    def slices(self, n: int) -> List[slice]:
        """This process's blocks of n rows, one a local card."""
        m = self.mesh
        if n % m.dp:
            raise ValueError(f"{n} rows do not split over the mesh's {m.dp} row blocks")
        b = n // m.dp
        return [slice(m.pop_index(i) * b, (m.pop_index(i) + 1) * b)
                for i in range(m.local_size)]

    def split(self, x: torch.Tensor) -> List[torch.Tensor]:
        """This process's blocks of x, each on its card."""
        return [x[s].to(d) for s, d in zip(self.slices(x.shape[0]), self.mesh.devices)]

    def gather(self, blocks: Sequence[torch.Tensor]) -> torch.Tensor:
        """The blocks of every row block, once each, whole on every rank, on
        the mesh's first card."""
        m = self.mesh
        # one block a model group (a rank-spanning group: the rank's one block)
        local = torch.cat([b.to(m.device) for b in blocks[::m.tp]])
        return cg_dist.fetch(local, m)


@dataclasses.dataclass(frozen=True)
class Replicated:
    """Every shard holds the whole value."""
    mesh: Mesh

    def place(self, x: torch.Tensor) -> List[torch.Tensor]:
        return [x.to(d) for d in self.mesh.devices]


def population_sharding(mesh: Mesh, axis: str = POP_AXIS) -> RowSharding:
    """Rows of [pop, ...] tensors split across the mesh's pop axis."""
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


# ------------------------------------------------------------ CLIP tensor parallelism

class ModelShards(tuple):
    """One tree a local card: the CLIP shard that card holds on a 2-D mesh
    (`shard_clip_tp`)."""


def _head_columns(w: torch.Tensor, tp: int, j: int) -> torch.Tensor:
    """Model position j's columns of a fused [..., 3D] q/k/v projection:
    its heads of q, of k and of v (heads are contiguous blocks of D)."""
    d = w.shape[-1] // 3
    return w.reshape(*w.shape[:-1], 3, tp, d // tp)[..., j, :].reshape(
        *w.shape[:-1], 3 * d // tp)


def _chunk(w: torch.Tensor, dim: int, tp: int, j: int) -> torch.Tensor:
    return w.chunk(tp, dim=dim)[j]


def clip_tp_spec(tp: int, j: int):
    """Model position j's slice of each leaf of a CLIP block, by name (the
    counterpart of clip_glass_tpu/parallel/mesh.py:43-78, on explicit
    collectives): the MLP's c_fc split by columns and c_proj by rows, the
    attention split by heads (q, k and v each, then out_proj's rows);
    anything not named (LNs, the output biases) is replicated."""
    return {
        "attn": {"in_proj_weight": lambda w: _head_columns(w, tp, j),
                 "in_proj_bias": lambda b: _head_columns(b, tp, j),
                 "out_proj_weight": lambda w: _chunk(w, 0, tp, j)},
        "mlp": {"c_fc_weight": lambda w: _chunk(w, 1, tp, j),
                "c_fc_bias": lambda b: _chunk(b, 0, tp, j),
                "c_proj_weight": lambda w: _chunk(w, 0, tp, j)},
    }


def clip_shard(params, tp: int, j: int):
    """Model position j of tp's shard of a CLIP tree (the port's layout):
    every block of both towers sliced by `clip_tp_spec`, its own copy;
    embeddings, LNs, the projections, logit_scale and a ResNet image tower
    whole. Its towers run with `encode_image` / `encode_text`'s `tp` and
    `reduce=model_sum` (models/clip/model.py), inside `Mesh.map`."""
    spec = clip_tp_spec(tp, j)

    def block(bp):
        return {grp: {k: (spec[grp][k](v).contiguous() if k in spec.get(grp, {}) else v)
                      for k, v in sub.items()}
                for grp, sub in bp.items()}

    def tower(t):
        return {k: ([block(b) for b in v] if k == "blocks" else v) for k, v in t.items()}

    return {k: (tower(v) if k in ("visual", "text") else v) for k, v in params.items()}


def clip_heads_divide(cfg, tp: int) -> None:
    """Raises unless both towers' heads split evenly over tp."""
    heads = [cfg.transformer_heads] + ([cfg.vision_heads] if cfg.vision_kind == "vit" else [])
    if any(h % tp for h in heads):
        raise ValueError(f"CLIP's heads {heads} do not split over a model axis of {tp}")


def shard_clip_tp(params, mesh: Mesh) -> ModelShards:
    """Each local card's CLIP shard, on that card (`clip_shard` of its model
    index): the counterpart of the JAX package's `shard_clip_tp`. A 1-D
    mesh gives every card the whole tree."""
    from clip_glass_torch.core.dtypes import tree_to

    return ModelShards(tree_to(clip_shard(params, mesh.tp, mesh.model_index(i))
                               if mesh.tp > 1 else params, d)
                       for i, d in enumerate(mesh.devices))


def model_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of x over the calling shard's model group (inside
    `Mesh.map`): an exchange between the group's threads, or `_AllReduceSum`
    over its ranks (on an abstract mesh a copy). Evaluation only: the
    threads' exchange carries no gradient."""
    mesh = getattr(_shard, "mesh", None)
    if mesh is None:
        raise RuntimeError("a CLIP model shard runs inside Mesh.map")
    if mesh.tp == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError("CLIP tensor parallelism serves evaluation only")
    if not mesh.model_spans_ranks:
        return _shard.model_exchange.sum(_shard.index % mesh.tp, x)
    return _AllReduceSum.apply(x, mesh.groups.model if mesh.groups is not None else None)


# ------------------------------------------------------------ collectives over the pop axis

class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks of `group` (None: every rank); its gradient is the
    same sum of the ranks' gradients (the loss is the sum of the ranks'
    losses), and that gradient is itself differentiable (a second
    derivative goes through it again). On meta tensors: the output's
    allocation alone."""

    @staticmethod
    def forward(ctx, x, group=None):
        ctx.group = group
        y = x.clone()
        if not y.is_meta:
            dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g, ctx.group), None


class _AllGatherRows(torch.autograd.Function):
    """The `n` ranks' equal row blocks (of `group`; None: every rank)
    concatenated in rank order on every rank; this rank is the r-th. Rank
    r's block feeds every rank's loss, so its gradient is the sum over ranks
    of the gathered gradient's block r: an all_reduce, differentiable, so
    that R1 and the path length penalty differentiate through it twice.
    Every rank reaches each gather, forward and backward, in one order. On
    meta tensors: the outputs' allocations alone."""

    @staticmethod
    def forward(ctx, x, group, n, r):
        ctx.rows, ctx.group, ctx.r = x.shape[0], group, r
        parts = [torch.empty_like(x) for _ in range(n)]
        if not x.is_meta:
            dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        r = ctx.r
        return (_AllReduceSum.apply(g.contiguous(), ctx.group)[r * ctx.rows:(r + 1) * ctx.rows],
                None, None, None)


def _gather_ranks(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    if mesh.pop_ranks == 1:
        return x
    return _AllGatherRows.apply(x, mesh.pop_group, mesh.pop_ranks, mesh.pop_rank)


def all_reduce_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Sum of x over the mesh's ranks, differentiable (x itself without a
    process group)."""
    if mesh is None or mesh.world == 1:
        return x
    return _AllReduceSum.apply(x, None)


def gather_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Every row block of a row-split tensor, once each, whole, in mesh
    order, on x's device: a torch.cat across this process's cards (whose
    threads meet here) and an all_gather across ranks over the pop axis,
    differentiable across ranks. Several cards in one process serve
    evaluation only: their threads do not share a backward pass."""
    if mesh is None or mesh.dp == 1:
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
    k = mesh.pop_index(getattr(_shard, "index", None) or 0)
    return full[k * rows:(k + 1) * rows]
