"""StyleGAN2 trainer, one process a card, data parallel over a mesh.

Behavioral reference: stylegan2/train.py: G/D alternating steps with the
non-saturating logistic loss (505-600), LAZY regularization (R1 every 16
iterations, path length every 4, with the interval-scaled learning-rate
correction, 101-124 and 946-958), style mixing with probability 0.9
(130-131), the moving-average generator Gs (293-302), checkpoint save and
resume with latest-directory discovery (820-939), a pluggable metric
registry (679-705) and scalar logging. The port of the JAX package's
`training/trainer.py`.

Data parallelism (`mesh`, parallel.mesh, one card a rank, the reference's
layout, train.py:258-277): each rank takes its rows of the global batch,
draws the global batch's draws from the same generator and keeps its rows,
and computes its share of each loss (its rows' sum over the global batch
size). D's minibatch-std gathers its input rows over the ranks
(`parallel.mesh.gather_rows`, whose gradient is an all_reduce and itself
differentiable: R1's and the path length penalty's second derivatives go
through it), the path length penalty's pl_avg follows the mean over every
rank's rows, and the gradients and logged losses are summed over the ranks
(one all_reduce a phase), so every rank takes the single process's Adam
step. Rank 0 writes the checkpoints.

The step differentiates through synthesis in the plain domain
(`s2d_min_res=2**30`, as the JAX package passes `s2d=False`), in fp32: on the
card kernels 1-3 run under grad through `ops.cuda.with_grad`, and the path
length penalty's gradient of a gradient goes through their twice
differentiable `cuda._KernelGrad`. D runs its plain domain (stock ops).

Every draw of a step (the z pairs, style-mixing uniforms and cutoffs, the
per-layer noise planes, the path length projection, the dlatent-average
batch) comes from the state's `torch.Generator`, or from a `StepDraws` the
caller passes (the tests feed the JAX package's draws this way). The
optimizers are optax's Adam written out (`core.optim`); a parameter that
took no gradient counts as a zero gradient. Host syncs happen only where a
value is read: `train` at `log_every`, and the checkpoints.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as tdist

from clip_glass_torch.core import memory, pytree
from clip_glass_torch.core.device import resolve_device
from clip_glass_torch.core.dtypes import FP32, map_tree, tree_leaves, tree_to, tree_unflatten
from clip_glass_torch.core.optim import AdamState, adam_init, adam_update, global_norm
from clip_glass_torch.models.stylegan2 import model as sg2
from clip_glass_torch.parallel import distributed as dist
from clip_glass_torch.parallel.mesh import all_reduce_sum
from clip_glass_torch.training import losses


@dataclasses.dataclass
class TrainerConfig:
    """Training hyperparameters. Overlayable from YAML files (the reference's
    yaml ConfigArgumentParser contract, stylegan2/utils.py:152-181) or from
    JSON (the same keys)."""
    batch_size: int = 4
    g_lr: float = 2e-3
    d_lr: float = 2e-3
    beta1: float = 0.0
    beta2: float = 0.99
    eps: float = 1e-8
    # regularizer cadences (reference train.py:101-124); 0 leaves the phase
    # out, like the reference's pl_reg_weight / r1_reg_weight <= 0 branches
    g_reg_interval: int = 4        # path-length cadence
    d_reg_interval: int = 16       # R1 cadence
    r1_gamma: float = 10.0
    pl_weight: float = 2.0
    pl_decay: float = 0.01
    style_mix_prob: float = 0.9    # reference train.py:130-131
    # running-average dlatent EMA for truncation (reference
    # models.py:219-229, 461-465)
    dlatent_avg_beta: float = 0.995
    # gradient-accumulation subdivisions (reference train.py:432-463,
    # 505-544): each optimizer step averages the grads of `subdivisions`
    # sequential micro-batches of batch_size / subdivisions
    subdivisions: int = 1
    ema_beta: float = 0.999        # Gs moving average (reference train.py:293-302)
    checkpoint_dir: str = "./checkpoints"
    checkpoint_every: int = 10000  # in seen images (reference train.py:668-674)
    seed: int = 0

    @classmethod
    def from_file(cls, path: str, **overrides) -> "TrainerConfig":
        """Load an overlay file: .yaml/.yml via pyyaml (the reference's
        yaml.safe_load, stylegan2/utils.py:160-181), anything else JSON. An
        unknown key raises: a typo'd key would train with the default."""
        if path.endswith((".yaml", ".yml")):
            import yaml
            with open(path) as f:
                data = yaml.safe_load(f) or {}
        else:
            with open(path) as f:
                data = json.load(f)
        data.update(overrides)
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(data) - fields)
        if unknown:
            raise ValueError(f"unknown TrainerConfig keys in {path}: "
                             f"{unknown}; valid: {sorted(fields)}")
        return cls(**data)

    # the JAX package's name for the same reader
    from_json = from_file

    def to_json(self, path: str):
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=1)

    def to_yaml(self, path: str):
        import yaml
        with open(path, "w") as f:
            yaml.safe_dump(dataclasses.asdict(self), f)


class TrainState(NamedTuple):
    g_params: dict
    d_params: dict
    g_opt: AdamState
    d_opt: AdamState
    gs_params: dict          # EMA generator
    pl_avg: torch.Tensor     # 0-d, on the trainer's device
    step: int
    key: Optional[torch.Generator]   # every draw of the steps (None: abstract); not checkpointed


class Latents(NamedTuple):
    """The style-mixing draws of one batch: z pairs [B, latent], the mixing
    uniform [B, 1] (mixing where below style_mix_prob) and the cutoff layer
    [B, 1], an integer in [1, num_latents)."""
    z1: torch.Tensor
    z2: torch.Tensor
    mix: torch.Tensor
    cutoff: torch.Tensor


class ChunkDraws(NamedTuple):
    """The draws of one subdivision chunk of a phase: its latents, and the
    per-layer noise planes (D and G phases, in `noise_shapes()` order) or
    the path length projection's standard normal y [B, C, H, W]."""
    latents: Latents
    noise: Optional[List[torch.Tensor]] = None
    y: Optional[torch.Tensor] = None


class StepDraws(NamedTuple):
    """Every draw of one step: a ChunkDraws per subdivision for the D, G and
    path length phases (`pl` None when that phase does not run) and the
    dlatent-average batch z [batch / subdivisions, latent]."""
    d: List[ChunkDraws]
    g: List[ChunkDraws]
    pl: Optional[List[ChunkDraws]]
    z_avg: torch.Tensor


def _lazy_lr(lr: float, beta1: float, beta2: float, interval: int):
    """Interval-scaled optimizer constants for lazy regularization
    (reference train.py:946-958)."""
    if interval <= 1:
        return lr, beta1, beta2
    c = interval / (interval + 1)
    return lr * c, beta1 ** c, beta2 ** c


def split_batch(x: torch.Tensor, S: int) -> torch.Tensor:
    """[B, ...] -> [S, B/S, ...]; raises when S does not divide B."""
    if x.shape[0] % S:
        raise ValueError(f"batch {x.shape[0]} not divisible by subdivisions {S}")
    return x.reshape(S, x.shape[0] // S, *x.shape[1:])


def accumulate_value_and_grads(fn: Callable, chunks: Sequence):
    """Mean of `fn`'s (value, grads) over the chunks (gradient accumulation,
    reference train.py:432-463, 505-544): a running sum in chunk order, so
    one chunk's graph is alive at a time. `fn(chunk)` returns (scalar, list
    of gradients)."""
    value, grads = fn(chunks[0])
    for chunk in chunks[1:]:
        v, g = fn(chunk)
        value = value + v
        grads = [a + b for a, b in zip(grads, g)]
    S = len(chunks)
    if S == 1:
        return value, grads
    return value / S, [g / S for g in grads]


def value_and_grad(fn: Callable, params, has_aux: bool = False):
    """fn(params) and its gradient with respect to every leaf of `params`
    (fresh leaves; a leaf that took no gradient gets zeros, as jax.grad
    gives them). Returns (value, grads) or, with has_aux, ((value, aux),
    grads), value and aux detached."""
    leaves = [(p.clone() if p.is_inference() else p.detach()).requires_grad_(True)
              for p in tree_leaves(params)]
    with torch.enable_grad():
        out = fn(tree_unflatten(params, leaves))
        value, aux = out if has_aux else (out, None)
        grads = torch.autograd.grad(value, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
    if has_aux:
        return (value.detach(), aux.detach()), grads
    return value.detach(), grads


def _apply(params, updates):
    return tree_unflatten(params, [p + u for p, u in zip(tree_leaves(params), updates)])


def _map_np(tree):
    return map_tree(lambda _, t: t.detach().cpu().numpy(), tree)


def _match(loaded, template, device):
    """The template's dict/list structure from an npz tree (lists come back
    as digit-keyed dicts), leaves as tensors on `device`."""
    if isinstance(template, (list, tuple)):
        return [_match(loaded[str(i)], t, device) for i, t in enumerate(template)]
    if isinstance(template, dict):
        return {k: _match(loaded[k], t, device) for k, t in template.items()}
    return torch.from_numpy(np.array(loaded)).to(device)


CHECKPOINT_FILES = ("kwargs.json", "G.npz", "D.npz", "Gs.npz", "G_opt.npz", "D_opt.npz")


class Trainer:
    """Entry point: runs on the card unless `device="cpu"`; the parameter
    trees are moved there. `g_params` / `d_params` in the port's layout
    (`weights.from_jax`), or None for the random init from `cfg.seed`.

    `mesh` (parallel.mesh.Mesh, one card a rank): data parallelism over its
    ranks; the trainer runs on the mesh's card, `batch_axes` (default: the
    mesh's axis) name its batch axis, and `cfg.batch_size` is the global
    batch: `train_step` takes this rank's rows (`local_rows`).

    `abstract=True` (the JAX package's, trainer.py:133-143): the state (G,
    D, Gs, both Adams, pl_avg, the step) is built on `meta` from shapes
    alone, no draw and no data, and a step runs at its real shapes for its
    memory (core.memory.PeakMemory); the draws are empty meta tensors (no
    generator lives on meta). With an abstract mesh of n positions
    (parallel.mesh.abstract_mesh: no process group) the step is one rank's:
    its batch / n rows, the collectives their outputs' allocations."""

    def __init__(self, model_cfg: Optional[sg2.SG2Config] = None,
                 cfg: Optional[TrainerConfig] = None, g_params=None, d_params=None,
                 mesh=None, batch_axes=None, device: Optional[str] = None,
                 abstract: bool = False):
        if mesh is None and batch_axes is not None:
            raise ValueError("batch_axes names axes of a mesh; pass the mesh")
        if mesh is not None and mesh.abstract != bool(abstract):
            raise ValueError("an abstract trainer goes with an abstract mesh "
                             "(parallel.mesh.abstract_mesh), and only it")
        self.mesh, self.batch_axes, self.world = mesh, None, 1
        if mesh is not None:
            if mesh.local_size != 1:
                raise ValueError(f"the trainer runs one process a card; this mesh gives "
                                 f"the process {mesh.local_size} (one rank a card)")
            if mesh.tp != 1:
                raise ValueError("the trainer is data parallel over a 1-D mesh; a model "
                                 "axis splits CLIP, which the trainer does not run")
            self.batch_axes = tuple(batch_axes) if batch_axes is not None else mesh.axis_names
            if not set(self.batch_axes) <= set(mesh.axis_names):
                raise ValueError(f"batch axes {self.batch_axes} are not axes of the mesh "
                                 f"{mesh.axis_names}")
            device, self.world = mesh.device, mesh.world
        self.abstract = bool(abstract)
        self.device = memory.META if abstract else resolve_device(device)
        self.model_cfg = model_cfg or sg2.TINY
        # the differentiated synthesis: the plain domain throughout
        self.plain_cfg = dataclasses.replace(self.model_cfg, s2d_min_res=2 ** 30)
        self.cfg = cfg or TrainerConfig()
        self.metrics: Dict[str, Callable] = {}
        init = torch.Generator().manual_seed(self.cfg.seed)
        with memory.abstract_construction() if abstract else contextlib.nullcontext():
            if g_params is None:
                g_params = sg2.generator_init(init, self.model_cfg)
            if d_params is None:
                d_params = sg2.discriminator_init(init, self.model_cfg)
        c = self.cfg
        self.g_adam = _lazy_lr(c.g_lr, c.beta1, c.beta2, c.g_reg_interval)
        self.d_adam = _lazy_lr(c.d_lr, c.beta1, c.beta2, c.d_reg_interval)
        g_params, d_params = tree_to(g_params, self.device), tree_to(d_params, self.device)
        self.state = TrainState(
            g_params=g_params, d_params=d_params,
            g_opt=adam_init(tree_leaves(g_params)), d_opt=adam_init(tree_leaves(d_params)),
            gs_params=g_params, pl_avg=torch.zeros((), device=self.device), step=0,
            key=None if abstract else torch.Generator(device=self.device).manual_seed(c.seed))

    def load_state(self, g_params, d_params, gs_params, g_opt: AdamState, d_opt: AdamState,
                   pl_avg, step: int) -> None:
        """Replace the state (not its generator) with these values, moved to
        the trainer's device: a checkpoint's or one carried across from the
        JAX package (`weights.from_jax.convert_train_state`)."""
        dev = self.device

        def opt(o):
            return AdamState(int(o.count), [t.to(dev) for t in o.mu], [t.to(dev) for t in o.nu])

        self.state = TrainState(tree_to(g_params, dev), tree_to(d_params, dev), opt(g_opt),
                                opt(d_opt), tree_to(gs_params, dev),
                                torch.as_tensor(pl_avg, dtype=torch.float32).to(dev),
                                int(step), self.state.key)

    # ------------------------------------------------------------ draws

    def _latents(self, gen: torch.Generator, batch: int) -> Latents:
        cfg, dev = self.model_cfg, self.device
        return Latents(torch.randn((batch, cfg.latent_size), generator=gen, device=dev),
                       torch.randn((batch, cfg.latent_size), generator=gen, device=dev),
                       torch.rand((batch, 1), generator=gen, device=dev),
                       torch.randint(1, cfg.num_latents, (batch, 1), generator=gen, device=dev))

    def _noise(self, gen: torch.Generator) -> Optional[List[torch.Tensor]]:
        if not self.model_cfg.noise:
            return None
        return [torch.randn(s, generator=gen, device=self.device)
                for s in self.model_cfg.noise_shapes()]

    def _own(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a tensor of the global batch's rows."""
        if self.world == 1:
            return x
        n = x.shape[0] // self.world
        return x[self.mesh.rank * n:(self.mesh.rank + 1) * n]

    def local_rows(self, reals: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global batch [B, ...]: its share of each
        subdivision chunk, in chunk order (its slice of the batch when
        subdivisions is 1). The batch itself without a process group."""
        S = max(1, int(self.cfg.subdivisions))
        return torch.cat(list(map(self._own, split_batch(reals, S))))

    def own_draws(self, draws: StepDraws) -> StepDraws:
        """This rank's rows of a step's draws of the global batch (the noise
        planes and the dlatent-average batch stay whole)."""
        if self.world == 1:
            return draws

        def chunk(c: ChunkDraws) -> ChunkDraws:
            return ChunkDraws(Latents(*map(self._own, c.latents)), c.noise,
                              None if c.y is None else self._own(c.y))

        return StepDraws([chunk(c) for c in draws.d], [chunk(c) for c in draws.g],
                         None if draws.pl is None else [chunk(c) for c in draws.pl],
                         draws.z_avg)

    def _share(self, loss: torch.Tensor) -> torch.Tensor:
        """A loss averaged over this rank's rows -> its share of the mean
        over the global batch (the ranks' equal shares sum to it)."""
        return loss if self.world == 1 else loss / self.world

    def _batch_mean(self, v: torch.Tensor) -> torch.Tensor:
        """The mean of a per-row vector over every rank's rows
        (differentiable)."""
        if self.world == 1:
            return v.mean()
        return all_reduce_sum(v.sum(), self.mesh) / (v.shape[0] * self.world)

    def _all_reduce(self, value: torch.Tensor, grads: List[torch.Tensor]):
        """(value, grads) summed over the ranks in one all_reduce."""
        if self.world == 1:
            return value, grads
        flat = torch.cat([value.reshape(1)] + [g.reshape(-1) for g in grads])
        if not flat.is_meta:   # an abstract mesh's rank moves nothing
            tdist.all_reduce(flat)
        out, at = [], 1
        for g in grads:
            out.append(flat[at:at + g.numel()].view_as(g))
            at += g.numel()
        return flat[0], out

    def draw(self, sub: int, S: int, path_length: bool) -> StepDraws:
        """A step's draws from the state's generator, for S chunks of `sub`."""
        gen, cfg = self.state.key, self.model_cfg
        d = [ChunkDraws(self._latents(gen, sub), self._noise(gen)) for _ in range(S)]
        g = [ChunkDraws(self._latents(gen, sub), self._noise(gen)) for _ in range(S)]
        pl = None
        if path_length:
            shape = (sub, cfg.data_channels, cfg.resolution, cfg.resolution)
            pl = [ChunkDraws(self._latents(gen, sub),
                             y=torch.randn(shape, generator=gen, device=self.device))
                  for _ in range(S)]
        z_avg = torch.randn((sub, cfg.latent_size), generator=gen, device=self.device)
        return StepDraws(d, g, pl, z_avg)

    # ------------------------------------------------------------ model fns

    def _gen_dlatents(self, g_params, lat: Latents) -> torch.Tensor:
        """Latents -> per-layer dlatents [B, num_latents, D] with style
        mixing (reference stylegan2/utils.py:292-322 PriorGenerator +
        models.py:425-458)."""
        cfg = self.model_cfg
        w1 = sg2.mapping_apply(g_params["mapping"], lat.z1, cfg)
        w2 = sg2.mapping_apply(g_params["mapping"], lat.z2, cfg)
        n = cfg.num_latents
        layer = torch.arange(n, device=w1.device)[None, :]
        use_w2 = (lat.mix < self.cfg.style_mix_prob) & (layer >= lat.cutoff)
        return torch.where(use_w2[:, :, None], w2[:, None, :].expand(-1, n, -1),
                           w1[:, None, :].expand(-1, n, -1))

    def _synthesize(self, g_params, dlatents, noise) -> torch.Tensor:
        return sg2.synthesis_apply(g_params["synthesis"], dlatents, self.plain_cfg,
                                   noise=noise, policy=FP32)

    def _d_apply(self, d_params, images) -> torch.Tensor:
        return sg2.discriminator_apply(d_params, images, self.model_cfg, mesh=self.mesh)

    # ------------------------------------------------------------ phases

    def d_loss(self, d_params, g_params, reals, draw: ChunkDraws) -> torch.Tensor:
        """D's logistic loss on reals and on fakes made without a gradient
        (this rank's share under a mesh)."""
        with torch.no_grad():
            fakes = self._synthesize(g_params, self._gen_dlatents(g_params, draw.latents),
                                     draw.noise)
        return self._share(losses.d_logistic(self._d_apply(d_params, reals),
                                             self._d_apply(d_params, fakes)))

    def d_reg(self, d_params, reals) -> torch.Tensor:
        """R1, scaled by its interval (lazy regularization)."""
        return self._share(losses.r1_penalty(self._d_apply, d_params, reals,
                                             self.cfg.r1_gamma)) * self.cfg.d_reg_interval

    def g_loss(self, g_params, d_params, draw: ChunkDraws) -> torch.Tensor:
        fakes = self._synthesize(g_params, self._gen_dlatents(g_params, draw.latents),
                                 draw.noise)
        return self._share(losses.g_logistic_ns(self._d_apply(d_params, fakes)))

    def g_reg(self, g_params, draw: ChunkDraws, pl_avg):
        """(path length penalty scaled by its interval, new pl_avg); the
        synthesis without noise."""
        dl = self._gen_dlatents(g_params, draw.latents)

        def synth(p, d):
            return self._synthesize(p, d, None)

        pen, new_avg = losses.path_length_reg(synth, g_params, dl, pl_avg, self.cfg.pl_decay,
                                              self.cfg.pl_weight, y=draw.y,
                                              batch_mean=self._batch_mean)
        return self._share(pen) * self.cfg.g_reg_interval, new_avg

    # ------------------------------------------------------------ step

    def train_step(self, reals: torch.Tensor, draws: Optional[StepDraws] = None) -> dict:
        """One step on reals [B, 3, H, W] in [-1, 1] on the trainer's device:
        the D phase (R1 every d_reg_interval steps), the G phase (the path
        length penalty every g_reg_interval steps, pl_avg carried through the
        subdivisions in turn), the dlatent_avg and Gs EMAs. Draws from the
        state's generator unless `draws` is given. Returns the logs (0-d
        tensors on the device, the grad norms of the pre-update grads).

        Under a mesh `reals` is this rank's rows (`local_rows` of the global
        batch) and `draws`, if given, the global batch's; every rank must
        call it, and the logs and the step are the global batch's."""
        if torch.is_inference_mode_enabled():
            raise RuntimeError("Trainer.train_step differentiates G and D: call it "
                               "outside torch.inference_mode()")
        cfg, st = self.cfg, self.state
        S = max(1, int(cfg.subdivisions))
        reals_s = split_batch(reals, S)
        sub = reals_s.shape[1] * self.world     # a chunk's rows over every rank
        do_d_reg = cfg.d_reg_interval > 0 and st.step % cfg.d_reg_interval == 0
        do_g_reg = cfg.g_reg_interval > 0 and st.step % cfg.g_reg_interval == 0
        if draws is None:
            draws = self.draw(sub, S, do_g_reg)
        draws = self.own_draws(draws)

        # ---- D phase
        d_loss, d_grads = accumulate_value_and_grads(
            lambda i: value_and_grad(
                lambda d: self.d_loss(d, st.g_params, reals_s[i], draws.d[i]), st.d_params),
            range(S))
        if do_d_reg:
            _, r1_grads = accumulate_value_and_grads(
                lambda i: value_and_grad(lambda d: self.d_reg(d, reals_s[i]), st.d_params),
                range(S))
            d_grads = [a + b for a, b in zip(d_grads, r1_grads)]
        d_loss, d_grads = self._all_reduce(d_loss, d_grads)
        with torch.no_grad():
            d_updates, d_opt = adam_update(d_grads, st.d_opt, *self.d_adam, cfg.eps)
            d_params = _apply(st.d_params, d_updates)

        # ---- G phase
        g_loss, g_grads = accumulate_value_and_grads(
            lambda i: value_and_grad(lambda g: self.g_loss(g, d_params, draws.g[i]),
                                     st.g_params),
            range(S))
        pl_avg = st.pl_avg
        if do_g_reg:
            pl_grads = None
            for i in range(S):
                (_, pl_avg), grads = value_and_grad(
                    lambda g: self.g_reg(g, draws.pl[i], pl_avg), st.g_params, has_aux=True)
                pl_grads = grads if pl_grads is None else [a + b for a, b in
                                                           zip(pl_grads, grads)]
            g_grads = [a + b / S for a, b in zip(g_grads, pl_grads)]
        g_loss, g_grads = self._all_reduce(g_loss, g_grads)
        with torch.no_grad():
            g_updates, g_opt = adam_update(g_grads, st.g_opt, *self.g_adam, cfg.eps)
            g_params = _apply(st.g_params, g_updates)

            # ---- dlatent_avg running EMA (reference models.py:461-465), once
            # a step from a fresh mapping batch
            w_avg = sg2.mapping_apply(g_params["mapping"], draws.z_avg,
                                      self.model_cfg).mean(dim=0)
            b = cfg.dlatent_avg_beta
            g_params = {**g_params,
                        "dlatent_avg": w_avg + (g_params["dlatent_avg"] - w_avg) * b}

            # ---- EMA Gs (reference train.py:293-302, 543-548)
            beta = cfg.ema_beta
            gs_params = tree_unflatten(st.gs_params, [
                beta * a + (1 - beta) * p
                for a, p in zip(tree_leaves(st.gs_params), tree_leaves(g_params))])
            logs = {"d_loss": d_loss, "g_loss": g_loss, "pl_avg": pl_avg,
                    "g_grad_norm": global_norm(g_grads), "d_grad_norm": global_norm(d_grads)}
        self.state = TrainState(g_params, d_params, g_opt, d_opt, gs_params, pl_avg,
                                st.step + 1, st.key)
        return logs

    # ------------------------------------------------------------ driving

    def train(self, data: Iterator, iterations: int, log_every: int = 0,
              logger: Optional[Callable] = None, sinks=None) -> dict:
        """data yields [B, 3, H, W] arrays or tensors in [-1, 1] (reference
        train.py:465-677). `sinks`: an optional training.logging.TrainLogger.
        The host reads the logs only every `log_every` steps. Returns the last
        logs (0-d tensors). Under a mesh each rank's `data` yields its slice
        of the global batch (the reference's per-rank DataLoader,
        train.py:465), and rank 0 alone logs and writes the sinks."""
        logs = {}
        primary = dist.is_primary()
        for it in range(iterations):
            raw = next(data)
            if self.mesh is not None:
                raw = dist.global_batch_from_local(self.mesh, raw, self.batch_axes)
            reals = torch.as_tensor(raw, dtype=torch.float32).to(self.device)
            logs = self.train_step(reals)
            step = self.state.step
            seen = step * self.cfg.batch_size
            if log_every and (it + 1) % log_every == 0 and primary:
                vals = {k: float(v) for k, v in logs.items()}
                (logger or (lambda s, v: print(f"[{s}] {v}")))(step, vals)
                if sinks is not None:
                    sinks.log_scalars(vals, step)
            if sinks is not None and primary:
                sinks.maybe_log_images(self, step)
            # fire when `seen` CROSSES a checkpoint_every boundary (a
            # divisibility test misses every boundary whose multiple is not
            # hit exactly, e.g. batch 6 / every 10000)
            every = self.cfg.checkpoint_every
            if every and seen // every > (seen - self.cfg.batch_size) // every:
                self.save_checkpoint()
        return logs

    def register_metric(self, name: str, fn: Callable):
        """Pluggable metric registry (reference train.py:679-705)."""
        self.metrics[name] = fn

    def evaluate_metrics(self) -> Dict[str, float]:
        return {name: float(fn(self.state)) for name, fn in self.metrics.items()}

    # ------------------------------------------------------------ checkpoints

    def _opt_tree(self, opt: AdamState, params) -> dict:
        return {"count": np.asarray(opt.count, np.int64),
                "mu": _map_np(tree_unflatten(params, opt.mu)),
                "nu": _map_np(tree_unflatten(params, opt.nu))}

    def save_checkpoint(self, folder: Optional[str] = None) -> str:
        """G, D, Gs and both optimizers' states as npz trees in the port's
        layout, then kwargs.json (seen, pl_avg, step, the config) last, so a
        save cut short never looks complete. Not the generator's state.
        Under a process group rank 0 writes and every rank returns once the
        folder is complete (every rank must call it)."""
        st = self.state
        seen = st.step * self.cfg.batch_size
        folder = folder or os.path.join(self.cfg.checkpoint_dir, str(seen))
        if dist.is_primary():
            self._write_checkpoint(folder, st, seen)
        dist.barrier()
        return folder

    def _write_checkpoint(self, folder: str, st: TrainState, seen: int) -> None:
        os.makedirs(folder, exist_ok=True)
        pytree.save_npz(os.path.join(folder, "G.npz"), _map_np(st.g_params))
        pytree.save_npz(os.path.join(folder, "D.npz"), _map_np(st.d_params))
        pytree.save_npz(os.path.join(folder, "Gs.npz"), _map_np(st.gs_params))
        pytree.save_npz(os.path.join(folder, "G_opt.npz"), self._opt_tree(st.g_opt, st.g_params))
        pytree.save_npz(os.path.join(folder, "D_opt.npz"), self._opt_tree(st.d_opt, st.d_params))
        with open(os.path.join(folder, "kwargs.json"), "w") as f:
            json.dump({"seen": seen, "pl_avg": float(st.pl_avg), "step": st.step,
                       "trainer": dataclasses.asdict(self.cfg)}, f)

    def load_checkpoint(self, folder: str):
        """Restore a save_checkpoint folder; the structure comes from the
        current state's trees (npz files hold lists as digit-keyed dicts)."""
        with open(os.path.join(folder, "kwargs.json")) as f:
            meta = json.load(f)
        st, dev = self.state, self.device

        def load(name, template):
            return _match(pytree.load_npz(os.path.join(folder, name)), template, dev)

        def opt(name, params):
            tree = pytree.load_npz(os.path.join(folder, name))
            return AdamState(int(tree["count"]),
                             tree_leaves(_match(tree["mu"], params, dev)),
                             tree_leaves(_match(tree["nu"], params, dev)))

        g_params = load("G.npz", st.g_params)
        d_params = load("D.npz", st.d_params)
        self.load_state(g_params, d_params, load("Gs.npz", st.gs_params),
                        opt("G_opt.npz", g_params), opt("D_opt.npz", d_params),
                        np.float32(meta["pl_avg"]), meta["step"])

    @staticmethod
    def latest_checkpoint(root: str) -> Optional[str]:
        """Latest-valid-checkpoint discovery (reference train.py:893-939):
        directories named by images seen, the newest complete one wins (a
        save killed mid-write lacks some file and is skipped)."""
        if not os.path.isdir(root):
            return None
        best, best_seen = None, -1
        for name in os.listdir(root):
            path = os.path.join(root, name)
            if not (os.path.isdir(path) and re.fullmatch(r"\d+", name)):
                continue
            if not set(CHECKPOINT_FILES).issubset(os.listdir(path)):
                continue
            if int(name) > best_seen:
                best, best_seen = path, int(name)
        return best
