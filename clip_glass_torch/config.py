"""Config registry: the 9 named search configurations.

The port's own copy of the registry the JAX package keeps (same names, same
search hyperparameters: genome bounds, population sizes, objectives). Values
are plain data; `model`/`latent` are family tags resolved by
`fitness.generator` and `fitness.latent`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass
class Config:
    """One named search configuration (field names follow the reference
    config dicts, reference config.py:6-30)."""

    # identity
    name: str = ""
    task: str = "txt2img"               # "txt2img" | "img2txt"
    # genome
    dim_z: int = 128
    n_var: int = 128
    n_obj: int = 1
    n_constr: int = 0
    xl: float = -2.0
    xu: float = 2.0
    # families
    latent: str = "biggan"              # "biggan" | "stylegan2" | "gpt2"
    model: str = "biggan"               # "biggan" | "stylegan2" | "gpt2"
    weights: str = ""
    use_discriminator: bool = False
    # search
    algorithm: str = "ga"               # "ga" | "nsga2"
    pop_size: int = 64
    batch_size: int = 32                # reference minibatch size (CLI parity)
    generations: int = 500
    save_each: int = 50
    # family-specific
    num_classes: int = 0                # BigGAN
    truncation: float = 1.0             # BigGAN
    norm: Optional[str] = None          # "biggan" -> (x+1)/2 clip[0,1]
    denorm: Optional[str] = None
    init_text: str = ""                 # GPT2
    max_tokens_len: int = 0             # GPT2 decode length
    max_text_len: int = 0               # GPT2 output truncation (chars)
    encoder_size: int = 0               # GPT2 vocab
    stochastic: bool = False            # GPT2 sampling mode
    # runtime
    target: str = ""
    tmp_folder: str = "./tmp"
    seed: int = 0
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    resolution: int = 0                 # synthesis resolution (0 = model default)
    mesh_shape: Optional[Tuple[int, ...]] = None
    # Evaluate the population in sequential chunks of this size (None = the
    # whole population at once). Must divide pop_size; keep it a multiple of
    # 4 so D's minibatch-std groups are unchanged.
    eval_microbatch: Optional[int] = None
    quantize: str = ""
    quantize_min_ch: int = 64
    quantize_margin: float = 1.25

    @property
    def problem_args(self) -> Dict[str, Any]:
        """Reference-shaped problem argument dict (reference config.py:24-29)."""
        return dict(n_var=self.n_var, n_obj=self.n_obj, n_constr=self.n_constr,
                    xl=self.xl, xu=self.xu)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def _stylegan2(name: str, dataset: str, use_d: bool) -> Config:
    # reference config.py:75-194: all six StyleGAN2 configs share these numbers.
    return Config(
        name=name, task="txt2img", dim_z=512, n_var=512,
        n_obj=2 if use_d else 1, n_constr=512, xl=-10.0, xu=10.0,
        latent="stylegan2", model="stylegan2",
        weights=f"./weights/stylegan2/{dataset}-config-f",
        use_discriminator=use_d, algorithm="nsga2" if use_d else "ga",
        norm="biggan", denorm="biggan", pop_size=16, batch_size=4,
    )


def _biggan(name: str, res: int, pop: int, batch: int) -> Config:
    # reference config.py:31-74.
    return Config(
        name=name, task="txt2img", dim_z=128, n_var=128 + 1000,
        n_obj=1, n_constr=128, xl=-2.0, xu=2.0,
        latent="biggan", model="biggan", weights=f"biggan-deep-{res}",
        use_discriminator=False, algorithm="ga",
        norm="biggan", denorm="biggan", truncation=1.0,
        num_classes=1000, pop_size=pop, batch_size=batch, resolution=res,
    )


_CONFIGS: Dict[str, Config] = {
    # reference config.py:6-30
    "GPT2": Config(
        name="GPT2", task="img2txt", dim_z=20, n_var=20, n_obj=1, n_constr=20,
        xl=0, xu=50256, latent="gpt2", model="gpt2",
        weights="./weights/gpt2/gpt2-pytorch_model.bin",
        use_discriminator=False, algorithm="ga",
        init_text="the picture of", stochastic=False,
        max_tokens_len=30, max_text_len=50, encoder_size=50257,
        pop_size=100, batch_size=25,
    ),
    "DeepMindBigGAN256": _biggan("DeepMindBigGAN256", 256, 64, 32),
    "DeepMindBigGAN512": _biggan("DeepMindBigGAN512", 512, 32, 8),
    "StyleGAN2_ffhq_d": _stylegan2("StyleGAN2_ffhq_d", "ffhq", True),
    "StyleGAN2_car_d": _stylegan2("StyleGAN2_car_d", "car", True),
    "StyleGAN2_church_d": _stylegan2("StyleGAN2_church_d", "church", True),
    "StyleGAN2_ffhq_nod": _stylegan2("StyleGAN2_ffhq_nod", "ffhq", False),
    "StyleGAN2_car_nod": _stylegan2("StyleGAN2_car_nod", "car", False),
    "StyleGAN2_church_nod": _stylegan2("StyleGAN2_church_nod", "church", False),
}


def get_config(name: str) -> Config:
    """Look up a named config (reference config.py:199-200)."""
    if name not in _CONFIGS:
        raise KeyError(f"unknown config {name!r}; choose from {sorted(_CONFIGS)}")
    return _CONFIGS[name].replace()


def list_configs():
    return sorted(_CONFIGS)
