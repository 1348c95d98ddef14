"""Generator facade: frozen CLIP + frozen StyleGAN2 G (+ D) + fitness.

Behavioral reference: reference generator.py:11-72 (class Generator): loads
CLIP ViT-B/32 and the config's model, encodes the target text once, and
scores candidates by CLIP cosine similarity, plus the discriminator hinge
for the `*_d` configs.

This slice covers the StyleGAN2 text-to-image branch. Parameters are either
drawn from seeded torch.Generators (`weights="random:<seed>"`) or handed in
as a converted bundle (`weights.from_jax.convert_bundle`). The per-layer
noise is fixed per search and is data: drawn once from a seeded generator,
or taken from the bundle, and folded into the s2d layouts once at staging.

When the model's top level runs in the space-to-depth domain (config-f:
s2d_min_res = 512), `eval_population` takes the s2d fitness path, as the JAX
package does: the synthesis hands over the packed image (s4d by default),
and the 224 px resize and the discriminator read it without the full-res
image ever being made. `generate` still returns full-resolution images.
"""

from __future__ import annotations

from typing import Optional

import torch

from clip_glass_torch.core.device import resolve_device
from clip_glass_torch.core.dtypes import Policy, precast_params, tree_to
from clip_glass_torch.fitness import latent as latent_mod
from clip_glass_torch.models.clip import model as clip_model
from clip_glass_torch.models.stylegan2 import model as sg2
from clip_glass_torch.ops import s2d as s2d_ops
from clip_glass_torch.ops.resize import resize_bilinear
from clip_glass_torch.tokenizers import tokenize

NOISE_SEED = 7


def biggan_norm(images):
    """[-1,1] -> [0,1] clipped (reference utils.py:14-17)."""
    return ((images + 1.0) / 2.0).clamp(0.0, 1.0)


def biggan_denorm(images):
    """[0,1] -> [-1,1] (reference utils.py:19-21)."""
    return images * 2.0 - 1.0


def _random_seed(weights: str) -> int:
    if not (isinstance(weights, str) and weights.startswith("random")):
        raise NotImplementedError(
            f"weights {weights!r}: checkpoint loading is not ported yet; use "
            "'random:<seed>' or pass a converted bundle")
    return int(weights.split(":")[1]) if ":" in weights else 0


def _cosine(a, b):
    a32, b32 = a.float(), b.float()
    num = (a32 * b32).sum(dim=-1)
    den = a32.norm(dim=-1) * b32.norm(dim=-1)
    return num / den.clamp_min(1e-12)


def random_bundle(config, clip_cfg, model_cfg, clip_weights: str = "random:0"):
    """Seeded random CLIP, G, D and noise planes (fp32, CPU). Draws happen on
    the CPU so one seed gives the same weights on every device."""
    gc = torch.Generator().manual_seed(_random_seed(clip_weights))
    gm = torch.Generator().manual_seed(_random_seed(config.weights))
    gn = torch.Generator().manual_seed(NOISE_SEED)
    bundle = {
        "clip": clip_model.init(gc, clip_cfg),
        "g": sg2.generator_init(gm, model_cfg),
        "noise": [torch.randn(s, generator=gn) for s in model_cfg.noise_shapes()],
    }
    if config.use_discriminator:
        bundle["d"] = sg2.discriminator_init(gm, model_cfg)
    return bundle


class Generator:
    """Owns CLIP + the StyleGAN2 parameters and computes the fitness."""

    def __init__(self, config, device=None, policy: Optional[Policy] = None,
                 clip_weights: str = "random:0", clip_cfg=None, model_cfg=None,
                 bundle=None):
        if config.model != "stylegan2" or config.task != "txt2img":
            raise NotImplementedError(
                f"config {config.name!r}: only the StyleGAN2 text-to-image "
                "branch is ported")
        self.config = config
        self.device = resolve_device(device)
        self.policy = policy or Policy.make(config.param_dtype, config.compute_dtype)
        self.clip_cfg = clip_cfg or clip_model.VIT_B_32
        self.model_cfg = model_cfg or sg2.CONFIG_F
        if bundle is None:
            bundle = random_bundle(config, self.clip_cfg, self.model_cfg,
                                   clip_weights)
        if config.use_discriminator and bundle.get("d") is None:
            raise ValueError(f"config {config.name!r} needs discriminator weights")

        def stage(tree, exclude=()):
            # frozen weights: cast to the compute dtype once, then move
            return tree_to(precast_params(tree, self.policy, exclude), self.device)

        self.clip_params = stage(bundle["clip"], clip_model.PRECAST_EXCLUDE)
        self.g_params = stage(bundle["g"], sg2.PRECAST_EXCLUDE)
        # D stays fp32, as in the JAX package: its s2d down-composite folds
        # compose FIR taps with the raw weights and round once at the end
        # (its plain branch casts every weight through the policy)
        self.d_params = (tree_to(bundle["d"], self.device)
                         if config.use_discriminator else None)
        self.noise = sg2.pack_noise(stage(list(bundle["noise"])), self.model_cfg,
                                    self.policy)
        if bundle.get("target") is not None:
            self.text_features = bundle["target"].to(self.device)
        else:
            with torch.inference_mode():
                tokens = torch.as_tensor(tokenize([config.target]), device=self.device)
                self.text_features = clip_model.encode_text(
                    self.clip_params, tokens, self.clip_cfg, self.policy)

    @property
    def bundle(self):
        """All device-resident state of the fitness computation."""
        b = {"clip": self.clip_params, "g": self.g_params, "noise": self.noise,
             "target": self.text_features}
        if self.d_params is not None:
            b["d"] = self.d_params
        return b

    def generate(self, X: torch.Tensor, bundle=None) -> torch.Tensor:
        """Genomes [pop, n_var] -> images [pop, 3, H, W] in [0, 1]."""
        bundle = bundle if bundle is not None else self.bundle
        (z,) = latent_mod.decode_stylegan2(X)
        imgs = sg2.generator_apply(bundle["g"], z, self.model_cfg,
                                   noise=bundle["noise"], policy=self.policy)
        return biggan_norm(imgs)

    def clip_similarity(self, generated, bundle=None) -> torch.Tensor:
        """Cosine similarity vs the cached target features (reference
        generator.py:43-59); images go to CLIP without mean/std normalization."""
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
        """The fitness runs end to end in the space-to-depth domain when the
        model's top level does (sg2.rgb_domain names the packed image)."""
        return sg2.top_level_s2d(self.model_cfg)

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
        sequential chunks, so peak activation memory is that of one chunk."""
        bundle = bundle if bundle is not None else self.bundle
        mb = self.config.eval_microbatch
        pop = X.shape[0]
        if not mb or pop <= mb:
            return self._eval_batch(X, bundle)
        if pop % mb:
            raise ValueError(f"eval_microbatch {mb} must divide pop_size {pop}")
        return torch.cat([self._eval_batch(X[i:i + mb], bundle)
                          for i in range(0, pop, mb)], dim=0)
