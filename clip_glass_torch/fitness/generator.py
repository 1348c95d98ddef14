"""Generator facade: frozen CLIP + the config's frozen generator (+ D) +
fitness.

Behavioral reference: reference generator.py:11-72 (class Generator): loads
CLIP ViT-B/32 and the config's model, encodes the target once (a text for
text-to-image, an image for GPT-2's image-to-text), and scores candidates by
CLIP cosine similarity, plus the discriminator hinge for the StyleGAN2 `*_d`
configs.

Parameters are drawn from seeded torch.Generators (`weights="random:<seed>"`),
read from the reference's own checkpoints (StyleGAN2's `.pth`, BigGAN's and
GPT-2's `.bin`, CLIP's `.pt`, through the converters of `weights/`), from
converted checkpoints (the npz trees and `_cfg.json` sidecars either
package's convert CLI writes), all carried across by `weights.from_jax`, or
handed in as a converted bundle (`weights.from_jax.convert_bundle`).
StyleGAN2's per-layer noise is fixed per search and is data: drawn once from
a seeded generator, or read from `<stem>_noise.npz`, or taken from the
bundle, and folded into the s2d layouts once at staging. BigGAN and GPT-2
have no D and no noise planes.

When StyleGAN2's top level runs in the space-to-depth domain (config-f:
s2d_min_res = 512), `eval_population` takes the s2d fitness path, as the JAX
package does: the synthesis hands over the packed image (s4d by default),
and the 224 px resize and the discriminator read it without the full-res
image ever being made. `generate` still returns full-resolution images.
BigGAN's fitness takes the plain path, as in the JAX package (its s2d mid
segments live inside the model): the full image, resized to 224 and scored.

GPT-2 (img2txt) is scored in stages, as the JAX package's
`host_eval_population`: the argmax decode on the device, a copy of the ids
to the host, the BPE round trip there (GPT-2 decode, cut at EOT, 50
characters, CLIP re-encode; reference models.py:32-42, generator.py:53-56),
and the CLIP text tower back on the device. A caption that overflows CLIP's
77 tokens zeroes the similarity of the whole population, as in the
reference.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from clip_glass_torch.core import memory, pytree
from clip_glass_torch.core.device import resolve_device
from clip_glass_torch.core.dtypes import Policy, precast_params, tree_to
from clip_glass_torch.core.profiling import TRACER
from clip_glass_torch.evolve.batched import search_seed
from clip_glass_torch.fitness import latent as latent_mod
from clip_glass_torch.models.biggan import model as bg
from clip_glass_torch.models.clip import model as clip_model
from clip_glass_torch.models.gpt2 import model as g2
from clip_glass_torch.models.stylegan2 import model as sg2
from clip_glass_torch.ops import quant
from clip_glass_torch.ops import s2d as s2d_ops
from clip_glass_torch.ops.resize import clip_preprocess_pil, resize_bilinear
from clip_glass_torch.parallel.mesh import (ModelShards, clip_heads_divide, model_sum,
                                            population_sharding, shard_clip_tp)
from clip_glass_torch.tokenizers import get_gpt2_tokenizer, tokenize
from clip_glass_torch.tokenizers.clip_bpe import CONTEXT_LENGTH
from clip_glass_torch.weights import convert_biggan, convert_gpt2, convert_stylegan2, from_jax
from clip_glass_torch.weights.load import is_random as _is_random
from clip_glass_torch.weights.load import load_clip as _load_clip
from clip_glass_torch.weights.load import random_seed as _random_seed
from clip_glass_torch.weights.load import read_cfg_sidecar as _read_cfg_sidecar

NOISE_SEED = 7
# GPT-2's sampling settings (reference gpt2/sample.py); the argmax decode of
# the GPT2 config (stochastic=False) reads neither
GPT2_TEMPERATURE = 0.7
GPT2_TOP_K = 40


def decode_draws(seed: int, n: int, steps: int, rows: int) -> torch.Tensor:
    """The sampled decode's uniforms [n, steps] (fp32, CPU) for n rows of a
    population decoded in chunks of `rows`: chunk c's rows and steps from a
    CPU generator seeded search_seed(seed, c), as the JAX package splits its
    key per chunk. They depend on the seed and the row's place in the whole
    population alone, so any split of the rows over cards, shards or ranks
    takes its slice and decodes as the whole would."""
    return torch.cat([_uniforms(search_seed(seed, c), min(rows, n - r), steps)
                      for c, r in enumerate(range(0, n, rows))])


def _uniforms(seed: int, n: int, steps: int) -> torch.Tensor:
    return torch.rand((n, steps), generator=torch.Generator().manual_seed(seed))


def biggan_norm(images):
    """[-1,1] -> [0,1] clipped (reference utils.py:14-17)."""
    return ((images + 1.0) / 2.0).clamp(0.0, 1.0)


def biggan_denorm(images):
    """[0,1] -> [-1,1] (reference utils.py:19-21)."""
    return images * 2.0 - 1.0


def _weights(bundle) -> dict:
    """A bundle without its target: the frozen weights alone."""
    return {k: v for k, v in bundle.items() if k != "target"}


def _shard_entries(shard, mesh) -> dict:
    """A bundle's CLIP entries on a tensor-parallel mesh: a card's model
    shard and the size of its model group (`Generator._encode`)."""
    return {"clip": shard, "clip_tp": mesh.tp}


def _cosine(a, b):
    a32, b32 = a.float(), b.float()
    num = (a32 * b32).sum(dim=-1)
    den = a32.norm(dim=-1) * b32.norm(dim=-1)
    return num / den.clamp_min(1e-12)


def _load_stylegan2(config, model_cfg):
    """G, D (for the `*_d` configs), noise planes (None: draw them) and the
    model config. `config.weights`: 'random:<seed>', or a directory, read in
    the JAX package's order of preference (generator.py:358-420): the
    reference's `Gs.pth` (the EMA generator, as the reference evaluates it)
    or `G.pth`, with `D.pth`; else the converted `Gs.npz` or `G.npz`, each
    with `<stem>_cfg.json`, `D.npz` and optionally `<stem>_noise.npz`. The
    checkpoint's config wins over the one passed in."""
    if _is_random(config.weights):
        gen = torch.Generator().manual_seed(_random_seed(config.weights))
        cfg = model_cfg or sg2.CONFIG_F
        g = sg2.generator_init(gen, cfg)
        d = sg2.discriminator_init(gen, cfg) if config.use_discriminator else None
        return g, d, None, cfg
    root = config.weights
    pth = next((p for p in (os.path.join(root, f"{s}.pth") for s in ("Gs", "G"))
                if os.path.exists(p)), None)
    if pth is not None:
        tree, cfg, _ = convert_stylegan2.load_pth(pth)
        d = None
        if config.use_discriminator:
            d = from_jax.convert_discriminator(
                convert_stylegan2.load_pth(os.path.join(root, "D.pth"))[0])
        return from_jax.convert_generator(tree), d, None, cfg
    stem = next((s for s in ("Gs", "G")
                 if os.path.exists(os.path.join(root, f"{s}.npz"))), None)
    if stem is None:
        raise FileNotFoundError(
            f"StyleGAN2 weights not found under {root!r} (Gs/G .pth or .npz); use "
            "the reference's checkpoints, convert them "
            "(python -m clip_glass_torch.weights.convert_weights) or use "
            "weights='random:<seed>'")
    g_path = os.path.join(root, f"{stem}.npz")
    cfg = _read_cfg_sidecar(g_path, sg2.SG2Config)
    if cfg is None:
        raise FileNotFoundError(f"{g_path}: its {stem}_cfg.json sidecar is missing")
    g = from_jax.convert_generator(pytree.restore_lists(pytree.load_npz(g_path)))
    d = None
    if config.use_discriminator:
        d = from_jax.convert_discriminator(pytree.restore_lists(
            pytree.load_npz(os.path.join(root, "D.npz"))))
    noise = None
    n_path = os.path.join(root, f"{stem}_noise.npz")
    if os.path.exists(n_path):
        with np.load(n_path) as data:
            noise = from_jax.convert_noise([data[k] for k in sorted(data.files, key=int)])
    return g, d, noise, cfg


def _biggan_default_cfg(config):
    return bg.CONFIGS[f"biggan-deep-{config.resolution}"]


def _load_biggan(config, model_cfg):
    """G and the model config. `config.weights`: 'random:<seed>' (the
    config's resolution names `bg.CONFIGS`' entry), a converted `.npz` with
    its `_cfg.json` sidecar, or the package's `pytorch_model.bin` read as the
    `biggan-deep-<resolution>` variant (the JAX package: generator.py:
    294-320); a config passed in wins over the file's."""
    w = config.weights
    if _is_random(w):
        gen = torch.Generator().manual_seed(_random_seed(w))
        cfg = model_cfg or _biggan_default_cfg(config)
        return bg.init(gen, cfg), cfg
    if not os.path.exists(w):
        raise FileNotFoundError(
            f"BigGAN weights not found at {w!r}; provide the pytorch_model.bin, a "
            "converted .npz (with its _cfg.json) or weights='random:<seed>'")
    if not w.endswith(".npz"):
        tree, cfg = convert_biggan.load_torch_checkpoint(w, f"biggan-deep-{config.resolution}")
        return from_jax.convert_biggan(tree), model_cfg or cfg
    cfg = (model_cfg or _read_cfg_sidecar(w, bg.BigGANConfig)
           or _biggan_default_cfg(config))
    return from_jax.convert_biggan(pytree.restore_lists(pytree.load_npz(w))), cfg


def _load_gpt2(config, model_cfg):
    """GPT-2 and its config. `config.weights`: 'random:<seed>', the
    reference's `gpt2-pytorch_model.bin`, or a converted `.npz` with its
    `_cfg.json` sidecar; a config passed in wins over the file's, and
    without either the geometry is read from the shapes (head width 64), as
    in the JAX package (generator.py:321-354)."""
    w = config.weights
    if _is_random(w):
        gen = torch.Generator().manual_seed(_random_seed(w))
        cfg = model_cfg or g2.GPT2_124M
        return g2.init(gen, cfg), cfg
    if not os.path.exists(w):
        raise FileNotFoundError(f"GPT-2 weights not found at {w!r}")
    if not w.endswith(".npz"):
        tree, cfg = convert_gpt2.load_torch_checkpoint(w)
        return from_jax.convert_gpt2(tree), model_cfg or cfg
    tree = pytree.load_npz(w)
    vocab, d = tree["wte"].shape
    cfg = (model_cfg or _read_cfg_sidecar(w, g2.GPT2Config)
           or g2.GPT2Config(vocab_size=vocab, n_positions=tree["wpe"].shape[0], n_embd=d,
                            n_layer=tree["blocks"]["ln_1"]["g"].shape[0],
                            n_head=12 if d == 768 else max(2, d // 64)))
    return from_jax.convert_gpt2(tree), cfg


def _default_model_cfg(config):
    if config.model == "biggan":
        return _biggan_default_cfg(config)
    return g2.GPT2_124M if config.model == "gpt2" else sg2.CONFIG_F


def load_bundle(config, clip_cfg=None, model_cfg=None, clip_weights: str = "random:0"):
    """CLIP, G, and for StyleGAN2 D and the noise planes (fp32, CPU) as
    `config.weights` and `clip_weights` name them, with the CLIP and model
    configs (a StyleGAN2 checkpoint's sidecar wins over the one passed in).
    Random draws happen on the CPU, so one seed gives the same weights on
    every device; noise planes a checkpoint does not hold are drawn from
    NOISE_SEED.

    "abstract" for either (the JAX package's weights="abstract"): every tree
    on `meta` at its real shapes and dtypes, from the configs alone (the
    defaults, or those passed in), with no draw and no file read
    (`core.memory.abstract_construction`)."""
    if memory.is_abstract(config.weights) or memory.is_abstract(clip_weights):
        with memory.abstract_construction():
            return load_bundle(config.replace(weights="random:0"), clip_cfg, model_cfg)
    clip, clip_cfg = _load_clip(clip_weights, clip_cfg)
    if config.model in ("biggan", "gpt2"):
        load = _load_biggan if config.model == "biggan" else _load_gpt2
        g, model_cfg = load(config, model_cfg)
        return {"clip": clip, "g": g}, clip_cfg, model_cfg
    g, d, noise, model_cfg = _load_stylegan2(config, model_cfg)
    if noise is None:
        gn = torch.Generator().manual_seed(NOISE_SEED)
        noise = [torch.randn(s, generator=gn) for s in model_cfg.noise_shapes()]
    bundle = {"clip": clip, "g": g, "noise": noise}
    if d is not None:
        bundle["d"] = d
    return bundle, clip_cfg, model_cfg


@torch.inference_mode()
def quantize_u8(images: torch.Tensor) -> torch.Tensor:
    """[0, 1] images -> uint8 on their own device, rounding as the JPEG
    writer does ((x*255 + 0.5) truncated), so the copy to the host is 4x
    smaller than fp32's."""
    return (images.float() * 255.0 + 0.5).clamp(0, 255).to(torch.uint8)


class Generator:
    """Owns CLIP + the generator's parameters and computes the fitness."""

    def __init__(self, config, device=None, policy: Optional[Policy] = None,
                 clip_weights: str = "random:0", clip_cfg=None, model_cfg=None,
                 bundle=None, mesh=None):
        if config.model not in ("stylegan2", "biggan", "gpt2"):
            raise ValueError(f"unknown model family {config.model!r}")
        self.config = config
        # weights="abstract": every tree on meta, shapes alone (load_bundle)
        self.abstract = memory.is_abstract(config.weights) or memory.is_abstract(clip_weights)
        self.device = memory.META if self.abstract else resolve_device(device)
        if mesh is not None and mesh.abstract != self.abstract:
            raise ValueError("abstract weights go with an abstract mesh "
                             "(parallel.mesh.abstract_mesh), and only they")
        # parallel.mesh.Mesh: the evaluations split their rows over its pop
        # axis, CLIP's towers over its model axis
        self.mesh = mesh
        self._replicas = {}   # card -> (the bundle's identity, its copy there)
        self.policy = policy or Policy.make(config.param_dtype, config.compute_dtype)
        with TRACER.span("setup.stage"):
            if bundle is None:
                bundle, self.clip_cfg, self.model_cfg = load_bundle(
                    config, clip_cfg, model_cfg, clip_weights)
            else:
                self.clip_cfg = clip_cfg or clip_model.VIT_B_32
                self.model_cfg = model_cfg or _default_model_cfg(config)
            if config.use_discriminator and bundle.get("d") is None:
                raise ValueError(f"config {config.name!r} needs discriminator weights")

            def stage(tree, exclude=()):
                # frozen weights: cast to the compute dtype once, then move
                return tree_to(precast_params(tree, self.policy, exclude), self.device)

            self.clip_params = stage(bundle["clip"], clip_model.PRECAST_EXCLUDE)
            if mesh is not None and mesh.tp > 1:
                # each local card holds its model shard of CLIP alone
                clip_heads_divide(self.clip_cfg, mesh.tp)
                self.clip_params = shard_clip_tp(self.clip_params, mesh)
            self.d_params = self.noise = None
            if config.model == "biggan":
                # the BN running statistics stay fp32 (bg.PRECAST_EXCLUDE)
                self.g_params = stage(bundle["g"], bg.PRECAST_EXCLUDE)
            elif config.model == "gpt2":
                # the matmul weights in the compute dtype once, for every decode
                # (sample_sequence's own cast is then a no-op); LN stays raw
                self.g_params = stage(bundle["g"], g2.PRECAST_EXCLUDE)
                ids = get_gpt2_tokenizer().encode(config.init_text)
                self.init_tokens = torch.tensor(ids, dtype=torch.int32, device=self.device)
            else:
                self.g_params = stage(bundle["g"], sg2.PRECAST_EXCLUDE)
                # D stays fp32, as in the JAX package: its s2d down-composite
                # folds compose FIR taps with the raw weights and round once at
                # the end (its plain branch casts every weight through the policy)
                self.d_params = (tree_to(bundle["d"], self.device)
                                 if config.use_discriminator else None)
                self.noise = sg2.pack_noise(stage(list(bundle["noise"])), self.model_cfg,
                                            self.policy)
        # the target's features, computed once (reference generator.py:22-27)
        if bundle.get("target") is not None:
            target = bundle["target"].to(self.device)
        else:
            target = self.encode_target(config.target)
        self.text_features = target if config.task == "txt2img" else None
        self.image_features = target if config.task == "img2txt" else None
        # the opt-in int8 fitness (ops/quant.py): activation scales per call
        # site; shapes alone have no values to calibrate on (the JAX
        # package skips it too), so an abstract run sizes the float path
        self._quant_scales = None
        if config.quantize and not self.abstract:
            with TRACER.span("setup.stage", part="int8"):
                self._calibrate_quant()

    @torch.inference_mode()
    def _calibrate_quant(self, X0: Optional[torch.Tensor] = None) -> None:
        """The int8 mode's activation scales (the JAX package's
        `_calibrate_quant`, generator.py:157-186): one float evaluation of X0,
        or of `eval_microbatch or pop_size` rows drawn with the config's
        sampling operator from a generator seeded config.seed, recording the
        input absmax of every eligible conv in call order, times
        config.quantize_margin (float64, on the host). The draw depends on
        the seed alone, so a resumed search recalibrates to the same scales.
        img2txt has no eligible conv and keeps None."""
        from clip_glass_torch.evolve.algorithm import operators_for_config

        cfg = self.config
        if cfg.quantize not in quant.INT8_MODES:
            raise ValueError(f"unknown quantize mode {cfg.quantize!r}; "
                             f"supported: {quant.INT8_MODES}")
        self._quant_scales = None
        if cfg.task == "img2txt":
            return
        if X0 is None:
            gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
            X0 = operators_for_config(cfg).sample(gen, cfg.eval_microbatch or cfg.pop_size)
        base = {k: v for k, v in self.bundle.items() if k != "clip"}

        def calibrate(clip, dev):
            with quant.calibration(cfg.quantize_min_ch) as records:
                self._eval_batch_raw(X0.to(dev), {**self._on(base, dev, self.device), **clip})
            return torch.stack(records).cpu() if records else None

        records = self._each_shard(calibrate)
        if records is not None:
            self._quant_scales = records.double().numpy() * cfg.quantize_margin

    @torch.inference_mode()
    def encode_target(self, target: str) -> torch.Tensor:
        """CLIP features [1, D] of a text prompt (txt2img) or of the image at
        the path `target` (img2txt, CLIP-preprocessed on the host)."""
        return self.encode_targets([target])

    @torch.inference_mode()
    def encode_targets(self, targets) -> torch.Tensor:
        """CLIP features [K, D] of K targets in one tower call: text prompts
        (txt2img) or image paths (img2txt), as the JAX package's
        `encode_targets` (generator.py:573-587); multi-search batching and
        serving score each search against its row."""
        targets = list(targets)
        with TRACER.span("setup.targets", n=len(targets)):
            if self.config.task == "txt2img":
                tokens = torch.as_tensor(tokenize(targets), device=self.device)
                return self._each_shard(lambda clip, dev: self._encode(
                    clip_model.encode_text, clip, tokens.to(dev))).to(self.device)
            from PIL import Image

            imgs = []
            for path in targets:
                with Image.open(path) as im:
                    imgs.append(clip_preprocess_pil(im, self.clip_cfg.image_resolution))
            imgs = torch.as_tensor(np.concatenate(imgs), device=self.device)
            return self._each_shard(lambda clip, dev: self._encode(
                clip_model.encode_image, clip, imgs.to(dev))).to(self.device)

    def _each_shard(self, fn):
        """fn(CLIP's bundle entries, their device) with the whole tower on
        the generator's device, or on a tensor-parallel mesh on every local
        card with the CLIP shard it holds (`_shard_entries`; every model
        group computes the same value): the first card's result."""
        clip = self.clip_params
        if not isinstance(clip, ModelShards):
            return fn({"clip": clip}, self.device)
        m = self.mesh
        return m.map(lambda i, _: fn(_shard_entries(clip[i], m), m.devices[i]),
                     [None] * m.local_size)[0]

    def _encode(self, tower, bundle, x: torch.Tensor) -> torch.Tensor:
        """tower (clip_model.encode_image or encode_text) of bundle's CLIP on
        x: the whole tower, or a model shard with its group's size
        (`"clip_tp"`, `_shard_entries`) and the sum over its group."""
        tp = bundle.get("clip_tp", 1)
        return tower(bundle["clip"], x, self.clip_cfg, self.policy, tp=tp,
                     reduce=model_sum if tp > 1 else None)

    @property
    def bundle(self):
        """All device-resident state of the fitness computation."""
        target = self.text_features if self.text_features is not None else self.image_features
        b = {"clip": self.clip_params, "g": self.g_params, "target": target}
        if self.noise is not None:
            b["noise"] = self.noise
        if self.d_params is not None:
            b["d"] = self.d_params
        return b

    def generate(self, X: torch.Tensor, bundle=None, seed: Optional[int] = None,
                 draws: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Genomes [pop, n_var] -> images [pop, 3, H, W] in [0, 1], or for
        GPT-2 token ids [pop, n_var + len(init_tokens) + max_tokens_len]: the
        decoded genome, the init text and the decode. With config.stochastic,
        GPT-2 samples with `draws` [pop, max_tokens_len] (`decode_draws`),
        or without them with uniforms from a CPU generator seeded `seed`, or
        config.seed without one (the JAX package's generate with and without
        a key)."""
        bundle = bundle if bundle is not None else self.bundle
        cfg = self.config
        with TRACER.span("models.G", rows=X.shape[0]):
            if cfg.model == "gpt2":
                (ids,) = latent_mod.decode_gpt2(X)
                init = self.init_tokens.to(ids.device).expand(ids.shape[0], -1)
                ctx = torch.cat([ids, init], dim=1)
                if cfg.stochastic and draws is None:
                    draws = _uniforms(cfg.seed if seed is None else seed, ids.shape[0],
                                      cfg.max_tokens_len)
                return g2.sample_sequence(bundle["g"], ctx, cfg.max_tokens_len,
                                          self.model_cfg, temperature=GPT2_TEMPERATURE,
                                          top_k=GPT2_TOP_K, sample=cfg.stochastic,
                                          draws=draws, policy=self.policy)
            if cfg.model == "biggan":
                z, cv = latent_mod.decode_biggan(X, self.config.dim_z)
                imgs = bg.apply(bundle["g"], z, cv, self.config.truncation, self.model_cfg,
                                self.policy)
                return biggan_norm(imgs)
            (z,) = latent_mod.decode_stylegan2(X)
            imgs = sg2.generator_apply(bundle["g"], z, self.model_cfg,
                                       noise=bundle["noise"], policy=self.policy)
            return biggan_norm(imgs)

    @torch.inference_mode()
    def render(self, X: torch.Tensor) -> np.ndarray:
        """What `save` writes for genomes X, on the host: uint8 images
        quantized on the device, or GPT-2's token ids."""
        out = self.generate(X)
        return (out if self.config.task == "img2txt" else quantize_u8(out)).cpu().numpy()

    def decode_texts(self, out_ids: np.ndarray):
        """Token matrix -> captions (reference models.py:32-42): the decode
        after the genome, cut at the first EOT (the init text stays), then
        truncated to max_text_len characters."""
        enc = get_gpt2_tokenizer()
        cfg = self.config
        texts = []
        for seq in np.asarray(out_ids).tolist():
            end = seq.index(enc.eot_id) if enc.eot_id in seq else len(seq)
            texts.append(enc.decode(seq[cfg.dim_z:end])[:cfg.max_text_len])
        return texts

    def _texts_to_clip_tokens(self, out_ids: np.ndarray):
        """The host side of the round trip: captions -> CLIP tokens [n, 77]
        int32 and ok [n] bool; when any caption overflows the context, zero
        tokens and ok all False (reference generator.py:53-56)."""
        texts = self.decode_texts(out_ids)
        try:
            return tokenize(texts), np.ones((len(texts),), np.bool_)
        except RuntimeError:
            return (np.zeros((len(texts), CONTEXT_LENGTH), np.int32),
                    np.zeros((len(texts),), np.bool_))

    @staticmethod
    def _place_like(X: torch.Tensor, toks: np.ndarray, ok: np.ndarray):
        """The host round trip's tokens and mask back on the population's
        device."""
        return (torch.as_tensor(toks, device=X.device),
                torch.as_tensor(ok, device=X.device))

    def _text_similarity(self, toks: torch.Tensor, ok: torch.Tensor, bundle,
                         mesh=None) -> torch.Tensor:
        """CLIP text tower on the round trip's tokens -> the cosine to the
        target image, 0 where ok is False. With K target rows in
        bundle["target"], the tokens are K searches' consecutive blocks and
        each block is scored against its own row. With a mesh the tower's
        rows split over it."""
        def tower(b, t):
            return self._encode(clip_model.encode_text, b, t)

        feats = (tower(bundle, toks) if mesh is None
                 else self._map_rows(tower, mesh, _weights(bundle), toks))
        target = bundle["target"]
        sim = _cosine(feats.reshape(target.shape[0], -1, feats.shape[-1]), target[:, None, :])
        return torch.where(ok, sim.reshape(-1), 0.0)

    def _decode(self, flat: torch.Tensor, bundle, rows: int,
                draws: Optional[torch.Tensor] = None) -> torch.Tensor:
        """GPT-2's decode of genomes [n, n_var] in chunks of `rows` rows, a
        sampled decode's rows with their rows of `draws` [n, steps]."""
        return torch.cat([self.generate(flat[r:r + rows], bundle, None,
                                        None if draws is None else draws[r:r + rows])
                          for r in range(0, flat.shape[0], rows)])

    def _decode_rows(self, flat: torch.Tensor, bundle, rows: int, mesh=None,
                     seed: Optional[int] = None) -> torch.Tensor:
        """The ids of genomes [n, n_var] (`_decode`), on the generator's
        device or with the rows split over `mesh`. A sampled decode
        (config.stochastic) draws every row's uniforms first,
        `decode_draws(seed, n, ...)` with config.seed when `seed` is None,
        and each shard decodes its rows with theirs: the ids are the
        one-device ids on any mesh."""
        draws = None
        if self.config.stochastic:
            draws = decode_draws(self.config.seed if seed is None else seed, flat.shape[0],
                                 self.config.max_tokens_len, rows)
        if mesh is None:
            return self._decode(flat, bundle, rows, draws)
        blocks = (flat,) if draws is None else (flat, draws)
        return self._map_rows(lambda b, x, d=None: self._decode(x, b, rows, d), mesh,
                              _weights(bundle), *blocks)

    def _eval_img2txt(self, Xb: torch.Tensor, targets: torch.Tensor, bundle,
                      rows: int, mesh=None, seed: Optional[int] = None) -> torch.Tensor:
        """GPT-2 fitness in stages for K searches, Xb [K, pop, n_var] against
        targets [K, D] -> F [K, pop, 1] (the JAX package's
        host_eval_population, and for K > 1 host_eval_population_batched):
        the decode in chunks of `rows` rows, all issued first, then their ids
        copied to the host; the round trip per search, where one overflowing
        caption zeroes its search's population; the text tower on all K*pop
        captions, each against its search's target. The chunks bound the
        decode's memory only: in eager PyTorch the host issues every launch
        of every chunk's decode before it reaches the first copy, so no round
        trip overlaps a decode (the JAX package's asynchronous dispatch
        can). With a mesh the decode and the text tower split their rows over
        it; the round trip reads the whole population on every rank. `seed`:
        the sampled decode's (config.stochastic): every row's uniforms come
        from it and the row's place in the whole population
        (`decode_draws`), so F on any mesh is the one-device F."""
        if self.abstract:
            raise NotImplementedError("GPT-2's host round trip reads the decoded ids: "
                                      "weights='abstract' sizes txt2img evaluations only")
        K, pop, n_var = Xb.shape
        ids = self._decode_rows(Xb.reshape(K * pop, n_var), bundle, rows, mesh, seed)
        ids = ids.cpu().numpy()
        toks, oks = zip(*(self._texts_to_clip_tokens(ids[r:r + pop])
                          for r in range(0, K * pop, pop)))
        sim = self._text_similarity(
            *self._place_like(Xb, np.concatenate(toks), np.concatenate(oks)),
            {**bundle, "target": targets}, mesh)
        return (-sim.reshape(K, pop, 1)).float()

    def clip_similarity(self, generated, bundle=None) -> torch.Tensor:
        """Cosine similarity of images vs the cached target features
        (reference generator.py:43-59); images go to CLIP without mean/std
        normalization (GPT-2's captions: `_eval_img2txt`)."""
        bundle = bundle if bundle is not None else self.bundle
        imgs = resize_bilinear(generated, self.clip_cfg.image_resolution)
        with TRACER.span("models.CLIP", rows=imgs.shape[0]):
            feats = self._encode(clip_model.encode_image, bundle, imgs)
        return _cosine(feats, bundle["target"])

    def discriminate(self, images, bundle=None, n_search: int = 1,
                     mesh=None) -> torch.Tensor:
        """[0,1] images -> D logits (reference generator.py:36-38 denorms
        back to [-1,1] first); `n_search` and `mesh` as in
        sg2.discriminator_apply."""
        bundle = bundle if bundle is not None else self.bundle
        with TRACER.span("models.D", rows=images.shape[0]):
            return sg2.discriminator_apply(bundle["d"], biggan_denorm(images),
                                           self.model_cfg, policy=self.policy,
                                           n_search=n_search, mesh=mesh)

    @property
    def _s2d_active(self) -> bool:
        """The StyleGAN2 fitness runs end to end in the space-to-depth
        domain when the model's top level does (sg2.rgb_domain names the
        packed image); BigGAN's never does, as in the JAX package."""
        return isinstance(self.model_cfg, sg2.SG2Config) and sg2.top_level_s2d(self.model_cfg)

    def generate_packed(self, X: torch.Tensor, bundle=None) -> torch.Tensor:
        """Genomes -> the packed [0, 1] image of the s2d path (the layout
        sg2.rgb_domain(model_cfg) names)."""
        bundle = bundle if bundle is not None else self.bundle
        with TRACER.span("models.G", rows=X.shape[0]):
            (z,) = latent_mod.decode_stylegan2(X)
            img = sg2.generator_apply(bundle["g"], z, self.model_cfg,
                                      noise=bundle["noise"], policy=self.policy,
                                      output_s2d=True)
            return biggan_norm(img)

    def clip_similarity_packed(self, img, bundle=None) -> torch.Tensor:
        """clip_similarity of a packed image: the phase-aware 224 px resize."""
        bundle = bundle if bundle is not None else self.bundle
        size = self.clip_cfg.image_resolution
        if sg2.rgb_domain(self.model_cfg) == "s4d":
            i224 = s2d_ops.resize_bilinear_from_s4d(img, size)
        else:
            i224 = s2d_ops.resize_bilinear_from_s2d(
                img, size, in_off=sg2.s2d_output_offset(self.model_cfg))
        with TRACER.span("models.CLIP", rows=i224.shape[0]):
            feats = self._encode(clip_model.encode_image, bundle, i224)
        return _cosine(feats, bundle["target"])

    def discriminate_packed(self, img, bundle=None, n_search: int = 1,
                            mesh=None) -> torch.Tensor:
        """discriminate of a packed image."""
        bundle = bundle if bundle is not None else self.bundle
        s4d = sg2.rgb_domain(self.model_cfg) == "s4d"
        with TRACER.span("models.D", rows=img.shape[0]):
            return sg2.discriminator_apply(
                bundle["d"], biggan_denorm(img), self.model_cfg, policy=self.policy,
                input_s2d=not s4d, input_offset=sg2.s2d_output_offset(self.model_cfg),
                input_s4d=s4d, n_search=n_search, mesh=mesh)

    def _eval_stylegan2_s2d(self, X: torch.Tensor, bundle, n_search: int = 1,
                            mesh=None) -> torch.Tensor:
        """s2d-domain fitness: decode -> synthesis (s2d features, packed RGB)
        -> [0, 1] -> phase-aware 224 px resize -> CLIP; D reads the packed
        image for the hinge (its minibatch-std over `mesh`: X is a shard's
        rows)."""
        img = self.generate_packed(X, bundle)
        sim = self.clip_similarity_packed(img, bundle)
        if self.config.n_obj == 2 and self.config.use_discriminator:
            d = self.discriminate_packed(img, bundle, n_search, mesh)
            hinge = torch.relu(1.0 - d[:, 0])
            return torch.stack([-sim, hinge], dim=1).float()
        return (-sim[:, None]).float()

    def _on(self, bundle, device: torch.device, home: torch.device):
        """`bundle` on `device`: itself on `home`, its own device; elsewhere
        the weights copied once a card (again only when the bundle's trees
        change) and the target each call."""
        if device == home:
            return bundle
        weights = _weights(bundle)
        key = tuple((k, id(v)) for k, v in sorted(weights.items()))
        hit = self._replicas.get(device)
        if hit is None or hit[0] != key:
            hit = self._replicas[device] = (key, tree_to(weights, device))
        out = dict(hit[1])
        if "target" in bundle:
            out["target"] = bundle["target"].to(device)
        return out

    def _map_rows(self, fn, mesh, bundle, *rows: torch.Tensor) -> torch.Tensor:
        """fn(bundle on the shard's card, *the shard's row blocks) over the
        mesh's shards of `rows` (tensors of one leading extent, contiguous
        blocks over the pop axis, parallel.mesh.RowSharding), gathered whole
        on every rank on the rows' device. A target with a row for each row
        splits with them; on a tensor-parallel mesh each card gets its CLIP
        shard, and the cards of a model group compute the same rows."""
        sharding = population_sharding(mesh)
        home, n = rows[0].device, rows[0].shape[0]
        shards = bundle.get("clip")
        if isinstance(shards, ModelShards):   # each card's CLIP shard
            if mesh is not self.mesh:
                raise ValueError("CLIP's model shards belong to the generator's own mesh")
            bundle = {k: v for k, v in bundle.items() if k != "clip"}
        else:
            shards = None
        target = bundle.get("target")
        targets = (sharding.split(target)
                   if target is not None and n > 1 and target.shape[0] == n else None)
        blocks = list(zip(*(sharding.split(r) for r in rows)))

        def run(i, block):
            b = self._on(bundle, mesh.devices[i], home)
            if targets is not None:
                b = {**b, "target": targets[i]}
            if shards is not None:
                b = {**b, **_shard_entries(shards[i], mesh)}
            return fn(b, *block)

        return sharding.gather(mesh.map(run, blocks)).to(home)

    def _eval_batch(self, X: torch.Tensor, bundle, n_search: int = 1,
                    mesh=None) -> torch.Tensor:
        """F of one batch. `n_search`: X holds that many searches' rows in
        consecutive blocks, `bundle["target"]` one row per row of X, and D
        pools within each block. With config.quantize the batch runs in a
        fresh int8 scope (ops/quant.py), which every evaluation path goes
        through: whole populations, their microbatches, K searches' batches
        and the server's. `generate` and `render` stay in the float path.

        `mesh`: the rows split over its shards in contiguous blocks, each
        evaluated on its card (each in its own int8 scope), F gathered whole
        on every rank. A row block that holds whole searches pools D within
        them alone; otherwise D's minibatch-std gathers its input rows over
        the mesh's pop axis, so F is the unsplit batch's. On a 2-D mesh G
        and D run on the model group's block on each of its cards, CLIP
        tensor-parallel over the group."""
        if mesh is None:
            return self._eval_shard(X, bundle, n_search, None)
        whole = n_search % mesh.dp == 0
        k, d_mesh = (n_search // mesh.dp, None) if whole else (n_search, mesh)
        return self._map_rows(lambda b, x: self._eval_shard(x, b, k, d_mesh), mesh, bundle, X)

    def _eval_shard(self, X: torch.Tensor, bundle, n_search: int, mesh) -> torch.Tensor:
        if self._quant_scales is None:
            return self._eval_batch_raw(X, bundle, n_search, mesh)
        with quant.int8_scope(self._quant_scales, self.config.quantize_min_ch):
            return self._eval_batch_raw(X, bundle, n_search, mesh)

    def _eval_batch_raw(self, X: torch.Tensor, bundle, n_search: int = 1,
                        mesh=None) -> torch.Tensor:
        if self._s2d_active:
            return self._eval_stylegan2_s2d(X, bundle, n_search, mesh)
        generated = self.generate(X, bundle)
        sim = self.clip_similarity(generated, bundle)
        if self.config.n_obj == 2 and self.config.use_discriminator:
            d = self.discriminate(generated, bundle, n_search, mesh)
            hinge = torch.relu(1.0 - d[:, 0])
            return torch.stack([-sim, hinge], dim=1).float()
        return (-sim[:, None]).float()

    def _decode_chunk(self, pop: int) -> int:
        """The rows a GPT-2 decode chunk of one population holds:
        config.eval_microbatch where it divides pop, else pop (the JAX
        package's host_eval_population)."""
        mb = self.config.eval_microbatch or pop
        return pop if pop % mb else mb

    @torch.inference_mode()
    def eval_population(self, X: torch.Tensor, bundle=None,
                        seed: Optional[int] = None) -> torch.Tensor:
        """[pop, n_var] -> [pop, n_obj] fitness (reference problem.py:14-29):
        F0 = -cosine similarity; F1 = relu(1 - D) hinge for *_d configs.
        `seed`: the sampled decode's under config.stochastic (GPT-2; a search
        draws one each generation), config.seed without one; no other
        fitness reads it.

        With config.eval_microbatch set, the population is evaluated in
        sequential chunks, so peak activation memory is that of one chunk
        (GPT-2: the decodes in chunks, the round trip and the text tower on
        the whole population; a microbatch that does not divide the
        population gives one chunk, as in the JAX package's
        host_eval_population).

        With `self.mesh` each batch splits its rows over the mesh
        (`_eval_batch`) and F comes back whole on every rank: the single
        process's F, up to the summation order of the smaller batches. A
        sampled decode draws the same uniforms for a row on any mesh
        (`decode_draws`)."""
        bundle = bundle if bundle is not None else self.bundle
        mb = self.config.eval_microbatch
        pop = X.shape[0]
        with TRACER.span("fitness.eval", rows=pop):
            if self.config.task == "img2txt":
                return self._eval_img2txt(X[None], bundle["target"], bundle,
                                          self._decode_chunk(pop), self.mesh, seed)[0]
            if mb and pop > mb and pop % mb:
                raise ValueError(f"eval_microbatch {mb} must divide pop_size {pop}")
            if not mb or pop <= mb:
                return self._eval_batch(X, bundle, mesh=self.mesh)
            return torch.cat([self._eval_batch(X[i:i + mb], bundle, mesh=self.mesh)
                              for i in range(0, pop, mb)], dim=0)

    @torch.inference_mode()
    def eval_population_batched(self, Xb: torch.Tensor, targets: torch.Tensor,
                                search_microbatch: Optional[int] = None,
                                mesh=None, seeds: Optional[Sequence[int]] = None
                                ) -> torch.Tensor:
        """K searches' populations at once: Xb [K, pop, n_var] against target
        features [K, D] (row i is search i's) -> F [K, pop, n_obj]; search
        i's F is what `eval_population` gives for Xb[i] against target i,
        as the JAX package's `vmap` of its evaluation over searches.

        G and CLIP run on the searches' rows together, the cosine is taken
        against each search's target and D's minibatch-std groups stay
        inside each search. `config.eval_microbatch` chunks each search's
        population (rows c*mb..(c+1)*mb of every search in one batch, D
        pooling per search and chunk). The searches go in chunks of
        `search_microbatch` (which must divide K): scheduling only, it
        bounds the activations to those of one chunk.

        GPT-2 (the JAX package's `host_eval_population_batched`): the
        decode in groups of `search_microbatch` searches, the host round
        trip per search (an overflow zeroes that search's population only),
        the text tower once at K*pop; `eval_microbatch` is not read. With
        config.stochastic each search is evaluated alone, in turn, as
        `eval_population` evaluates it (its decode in chunks of
        `eval_microbatch`), over `mesh`, its decode's uniforms drawn from its
        entry of `seeds` (each search's own draw, evolve/batched.py), or
        config.seed without them.

        `mesh` (default `self.mesh`): every batch splits its rows over it
        (`_eval_batch`); where the shards hold whole searches, D pools
        inside each card."""
        with TRACER.span("fitness.eval", rows=Xb.shape[0] * Xb.shape[1]):
            mesh = mesh if mesh is not None else self.mesh
            K, pop, n_var = Xb.shape
            if targets.shape[0] != K:
                raise ValueError(f"{targets.shape[0]} targets for {K} searches")
            smb = min(search_microbatch or K, K)
            if K % smb:
                raise ValueError(f"search_microbatch {smb} must divide n_search {K}")
            bundle = self.bundle
            if self.config.task == "img2txt":
                if self.config.stochastic:
                    return torch.cat([
                        self._eval_img2txt(Xb[i:i + 1], targets[i:i + 1], bundle,
                                           self._decode_chunk(pop), mesh,
                                           None if seeds is None else seeds[i])
                        for i in range(K)])
                return self._eval_img2txt(Xb, targets, bundle, smb * pop, mesh)
            mb = self.config.eval_microbatch
            if mb and pop > mb and pop % mb:
                raise ValueError(f"eval_microbatch {mb} must divide pop_size {pop}")
            if not mb or pop <= mb:
                mb = pop
            out = []
            for s in range(0, K, smb):
                rows = {**bundle, "target": targets[s:s + smb].repeat_interleave(mb, dim=0)}
                out.append(torch.cat([
                    self._eval_batch(Xb[s:s + smb, c:c + mb].reshape(smb * mb, n_var), rows,
                                     n_search=smb, mesh=mesh).reshape(smb, mb, -1)
                    for c in range(0, pop, mb)], dim=1))
            return torch.cat(out)

    def save(self, generated: np.ndarray, path: str):
        """Artifact dump (reference generator.py:63-72) of what `render`
        gives: an image grid (or the image itself for one) from uint8
        [B, 3, H, W], or GPT-2's captions of token ids [B, T], one a line."""
        if self.config.task == "img2txt":
            with open(path, "w") as f:
                f.write("\n".join(self.decode_texts(generated)))
            return
        from clip_glass_torch.utils.image import save_grid

        save_grid(generated, path)
