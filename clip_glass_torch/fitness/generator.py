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
from typing import Optional

import numpy as np
import torch

from clip_glass_torch.core import pytree
from clip_glass_torch.core.device import resolve_device
from clip_glass_torch.core.dtypes import Policy, precast_params, tree_to
from clip_glass_torch.fitness import latent as latent_mod
from clip_glass_torch.models.biggan import model as bg
from clip_glass_torch.models.clip import model as clip_model
from clip_glass_torch.models.gpt2 import model as g2
from clip_glass_torch.models.stylegan2 import model as sg2
from clip_glass_torch.ops import s2d as s2d_ops
from clip_glass_torch.ops.resize import clip_preprocess_pil, resize_bilinear
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


def biggan_norm(images):
    """[-1,1] -> [0,1] clipped (reference utils.py:14-17)."""
    return ((images + 1.0) / 2.0).clamp(0.0, 1.0)


def biggan_denorm(images):
    """[0,1] -> [-1,1] (reference utils.py:19-21)."""
    return images * 2.0 - 1.0


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
    NOISE_SEED."""
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
                 bundle=None):
        if config.model not in ("stylegan2", "biggan", "gpt2"):
            raise ValueError(f"unknown model family {config.model!r}")
        self.config = config
        self.device = resolve_device(device)
        self.policy = policy or Policy.make(config.param_dtype, config.compute_dtype)
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

    @torch.inference_mode()
    def encode_target(self, target: str) -> torch.Tensor:
        """CLIP features [1, D] of a text prompt (txt2img) or of the image at
        the path `target` (img2txt, CLIP-preprocessed on the host)."""
        if self.config.task == "txt2img":
            tokens = torch.as_tensor(tokenize([target]), device=self.device)
            return clip_model.encode_text(self.clip_params, tokens, self.clip_cfg,
                                          self.policy)
        from PIL import Image

        with Image.open(target) as im:
            img = clip_preprocess_pil(im, self.clip_cfg.image_resolution)
        return clip_model.encode_image(self.clip_params, torch.as_tensor(img, device=self.device),
                                       self.clip_cfg, self.policy)

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

    def generate(self, X: torch.Tensor, bundle=None) -> torch.Tensor:
        """Genomes [pop, n_var] -> images [pop, 3, H, W] in [0, 1], or for
        GPT-2 token ids [pop, n_var + len(init_tokens) + max_tokens_len]: the
        decoded genome, the init text and the decode. With config.stochastic,
        GPT-2 samples from a generator seeded config.seed at each call (the
        JAX package's generate without a key)."""
        bundle = bundle if bundle is not None else self.bundle
        cfg = self.config
        if cfg.model == "gpt2":
            (ids,) = latent_mod.decode_gpt2(X)
            ctx = torch.cat([ids, self.init_tokens.expand(ids.shape[0], -1)], dim=1)
            generator = (torch.Generator(device=X.device).manual_seed(cfg.seed)
                         if cfg.stochastic else None)
            return g2.sample_sequence(bundle["g"], ctx, cfg.max_tokens_len, self.model_cfg,
                                      temperature=GPT2_TEMPERATURE, top_k=GPT2_TOP_K,
                                      sample=cfg.stochastic, generator=generator,
                                      policy=self.policy)
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

    def _text_similarity(self, toks: torch.Tensor, ok: torch.Tensor, bundle) -> torch.Tensor:
        """CLIP text tower on the round trip's tokens -> the cosine to the
        target image, 0 where ok is False."""
        feats = clip_model.encode_text(bundle["clip"], toks, self.clip_cfg, self.policy)
        return torch.where(ok, _cosine(feats, bundle["target"]), 0.0)

    def _eval_img2txt(self, X: torch.Tensor, bundle, mb: int) -> torch.Tensor:
        """GPT-2 fitness in stages (the JAX package's host_eval_population):
        the decode in chunks of `mb` rows, all issued first, then each copied
        to the host and tokenized in order; the text tower on the whole
        population. The chunks bound the decode's memory only: in eager
        PyTorch the host issues every launch of every chunk's decode before
        it reaches the first copy, so no round trip overlaps a decode (the
        JAX package's asynchronous dispatch can). One overflow anywhere
        zeroes the whole population."""
        chunks = [self.generate(X[i:i + mb], bundle) for i in range(0, X.shape[0], mb)]
        toks, oks = zip(*(self._texts_to_clip_tokens(c.cpu().numpy()) for c in chunks))
        ok = np.concatenate(oks)
        if not ok.all():
            ok[:] = False
        sim = self._text_similarity(*self._place_like(X, np.concatenate(toks), ok), bundle)
        return (-sim[:, None]).float()

    def clip_similarity(self, generated, bundle=None) -> torch.Tensor:
        """Cosine similarity of images vs the cached target features
        (reference generator.py:43-59); images go to CLIP without mean/std
        normalization (GPT-2's captions: `_eval_img2txt`)."""
        bundle = bundle if bundle is not None else self.bundle
        imgs = resize_bilinear(generated, self.clip_cfg.image_resolution)
        feats = clip_model.encode_image(bundle["clip"], imgs, self.clip_cfg,
                                        self.policy)
        return _cosine(feats, bundle["target"])

    def discriminate(self, images, bundle=None) -> torch.Tensor:
        """[0,1] images -> D logits (reference generator.py:36-38 denorms
        back to [-1,1] first)."""
        bundle = bundle if bundle is not None else self.bundle
        return sg2.discriminator_apply(bundle["d"], biggan_denorm(images),
                                       self.model_cfg, policy=self.policy)

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
        feats = clip_model.encode_image(bundle["clip"], i224, self.clip_cfg,
                                        self.policy)
        return _cosine(feats, bundle["target"])

    def discriminate_packed(self, img, bundle=None) -> torch.Tensor:
        """discriminate of a packed image."""
        bundle = bundle if bundle is not None else self.bundle
        s4d = sg2.rgb_domain(self.model_cfg) == "s4d"
        return sg2.discriminator_apply(
            bundle["d"], biggan_denorm(img), self.model_cfg, policy=self.policy,
            input_s2d=not s4d, input_offset=sg2.s2d_output_offset(self.model_cfg),
            input_s4d=s4d)

    def _eval_stylegan2_s2d(self, X: torch.Tensor, bundle) -> torch.Tensor:
        """s2d-domain fitness: decode -> synthesis (s2d features, packed RGB)
        -> [0, 1] -> phase-aware 224 px resize -> CLIP; D reads the packed
        image for the hinge."""
        img = self.generate_packed(X, bundle)
        sim = self.clip_similarity_packed(img, bundle)
        if self.config.n_obj == 2 and self.config.use_discriminator:
            hinge = torch.relu(1.0 - self.discriminate_packed(img, bundle)[:, 0])
            return torch.stack([-sim, hinge], dim=1).float()
        return (-sim[:, None]).float()

    def _eval_batch(self, X: torch.Tensor, bundle) -> torch.Tensor:
        if self._s2d_active:
            return self._eval_stylegan2_s2d(X, bundle)
        generated = self.generate(X, bundle)
        sim = self.clip_similarity(generated, bundle)
        if self.config.n_obj == 2 and self.config.use_discriminator:
            d = self.discriminate(generated, bundle)
            hinge = torch.relu(1.0 - d[:, 0])
            return torch.stack([-sim, hinge], dim=1).float()
        return (-sim[:, None]).float()

    @torch.inference_mode()
    def eval_population(self, X: torch.Tensor, bundle=None) -> torch.Tensor:
        """[pop, n_var] -> [pop, n_obj] fitness (reference problem.py:14-29):
        F0 = -cosine similarity; F1 = relu(1 - D) hinge for *_d configs.

        With config.eval_microbatch set, the population is evaluated in
        sequential chunks, so peak activation memory is that of one chunk
        (GPT-2: the decodes in chunks, the round trip and the text tower on
        the whole population; a microbatch that does not divide the
        population gives one chunk, as in the JAX package's
        host_eval_population)."""
        bundle = bundle if bundle is not None else self.bundle
        mb = self.config.eval_microbatch
        pop = X.shape[0]
        if self.config.task == "img2txt":
            mb = mb or pop
            return self._eval_img2txt(X, bundle, pop if pop % mb else mb)
        if mb and pop > mb and pop % mb:
            raise ValueError(f"eval_microbatch {mb} must divide pop_size {pop}")
        if not mb or pop <= mb:
            return self._eval_batch(X, bundle)
        return torch.cat([self._eval_batch(X[i:i + mb], bundle)
                          for i in range(0, pop, mb)], dim=0)

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
