"""StyleGAN2 trainer, one process on one device.

Behavioral reference: stylegan2/train.py: G/D alternating steps with the
non-saturating logistic loss (505-600), LAZY regularization (R1 every 16
iterations, path length every 4, with the interval-scaled learning-rate
correction, 101-124 and 946-958), style mixing with probability 0.9
(130-131), the moving-average generator Gs (293-302), checkpoint save and
resume with latest-directory discovery (820-939), a pluggable metric
registry (679-705) and scalar logging. The port of the JAX package's
`training/trainer.py` for `mesh=None`: training over a mesh of cards is
ROADMAP item 16.

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

import dataclasses
import json
import os
import re
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from clip_glass_torch.core import pytree
from clip_glass_torch.core.device import resolve_device
from clip_glass_torch.core.dtypes import FP32, map_tree, tree_leaves, tree_to, tree_unflatten
from clip_glass_torch.core.optim import AdamState, adam_init, adam_update, global_norm
from clip_glass_torch.models.stylegan2 import model as sg2
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
    key: torch.Generator     # every draw of the steps; not checkpointed


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
    (`weights.from_jax`), or None for the random init from `cfg.seed`."""

    def __init__(self, model_cfg: Optional[sg2.SG2Config] = None,
                 cfg: Optional[TrainerConfig] = None, g_params=None, d_params=None,
                 mesh=None, batch_axes=None, device: Optional[str] = None):
        if mesh is not None or batch_axes is not None:
            raise ValueError("training over a mesh of cards is data parallelism, "
                             "ROADMAP item 16")
        self.device = resolve_device(device)
        self.model_cfg = model_cfg or sg2.TINY
        # the differentiated synthesis: the plain domain throughout
        self.plain_cfg = dataclasses.replace(self.model_cfg, s2d_min_res=2 ** 30)
        self.cfg = cfg or TrainerConfig()
        self.metrics: Dict[str, Callable] = {}
        init = torch.Generator().manual_seed(self.cfg.seed)
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
            key=torch.Generator(device=self.device).manual_seed(c.seed))

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
        return sg2.discriminator_apply(d_params, images, self.model_cfg)

    # ------------------------------------------------------------ phases

    def d_loss(self, d_params, g_params, reals, draw: ChunkDraws) -> torch.Tensor:
        """D's logistic loss on reals and on fakes made without a gradient."""
        with torch.no_grad():
            fakes = self._synthesize(g_params, self._gen_dlatents(g_params, draw.latents),
                                     draw.noise)
        return losses.d_logistic(self._d_apply(d_params, reals),
                                 self._d_apply(d_params, fakes))

    def d_reg(self, d_params, reals) -> torch.Tensor:
        """R1, scaled by its interval (lazy regularization)."""
        return losses.r1_penalty(self._d_apply, d_params, reals,
                                 self.cfg.r1_gamma) * self.cfg.d_reg_interval

    def g_loss(self, g_params, d_params, draw: ChunkDraws) -> torch.Tensor:
        fakes = self._synthesize(g_params, self._gen_dlatents(g_params, draw.latents),
                                 draw.noise)
        return losses.g_logistic_ns(self._d_apply(d_params, fakes))

    def g_reg(self, g_params, draw: ChunkDraws, pl_avg):
        """(path length penalty scaled by its interval, new pl_avg); the
        synthesis without noise."""
        dl = self._gen_dlatents(g_params, draw.latents)

        def synth(p, d):
            return self._synthesize(p, d, None)

        pen, new_avg = losses.path_length_reg(synth, g_params, dl, pl_avg, self.cfg.pl_decay,
                                              self.cfg.pl_weight, y=draw.y)
        return pen * self.cfg.g_reg_interval, new_avg

    # ------------------------------------------------------------ step

    def train_step(self, reals: torch.Tensor, draws: Optional[StepDraws] = None) -> dict:
        """One step on reals [B, 3, H, W] in [-1, 1] on the trainer's device:
        the D phase (R1 every d_reg_interval steps), the G phase (the path
        length penalty every g_reg_interval steps, pl_avg carried through the
        subdivisions in turn), the dlatent_avg and Gs EMAs. Draws from the
        state's generator unless `draws` is given. Returns the logs (0-d
        tensors on the device, the grad norms of the pre-update grads)."""
        if torch.is_inference_mode_enabled():
            raise RuntimeError("Trainer.train_step differentiates G and D: call it "
                               "outside torch.inference_mode()")
        cfg, st = self.cfg, self.state
        S = max(1, int(cfg.subdivisions))
        reals_s = split_batch(reals, S)
        sub = reals_s.shape[1]
        do_d_reg = cfg.d_reg_interval > 0 and st.step % cfg.d_reg_interval == 0
        do_g_reg = cfg.g_reg_interval > 0 and st.step % cfg.g_reg_interval == 0
        if draws is None:
            draws = self.draw(sub, S, do_g_reg)

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
        logs (0-d tensors)."""
        logs = {}
        for it in range(iterations):
            reals = torch.as_tensor(next(data), dtype=torch.float32).to(self.device)
            logs = self.train_step(reals)
            step = self.state.step
            seen = step * self.cfg.batch_size
            if log_every and (it + 1) % log_every == 0:
                vals = {k: float(v) for k, v in logs.items()}
                (logger or (lambda s, v: print(f"[{s}] {v}")))(step, vals)
                if sinks is not None:
                    sinks.log_scalars(vals, step)
            if sinks is not None:
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
        save cut short never looks complete. Not the generator's state."""
        st = self.state
        seen = st.step * self.cfg.batch_size
        folder = folder or os.path.join(self.cfg.checkpoint_dir, str(seen))
        os.makedirs(folder, exist_ok=True)
        pytree.save_npz(os.path.join(folder, "G.npz"), _map_np(st.g_params))
        pytree.save_npz(os.path.join(folder, "D.npz"), _map_np(st.d_params))
        pytree.save_npz(os.path.join(folder, "Gs.npz"), _map_np(st.gs_params))
        pytree.save_npz(os.path.join(folder, "G_opt.npz"), self._opt_tree(st.g_opt, st.g_params))
        pytree.save_npz(os.path.join(folder, "D_opt.npz"), self._opt_tree(st.d_opt, st.d_params))
        with open(os.path.join(folder, "kwargs.json"), "w") as f:
            json.dump({"seen": seen, "pl_avg": float(st.pl_avg), "step": st.step,
                       "trainer": dataclasses.asdict(self.cfg)}, f)
        return folder

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
