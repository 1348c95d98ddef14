"""A throwaway copy of the benchmark's data at tiny sizes, for CPU tests:
configuration files of the three families at test widths (GPT-2 at the
port's `models.gpt2.model.TINY`), small traffic
mixes, wide limits, and the metric readers copied from the benchmark.

Each committed cell has the tiny cell of its configuration's `family` and
its traffic's `kind` as its stand-in (`stand_ins`), found from the
committed files: a cell added by files alone gets one without an edit
here, and one whose family or kind has no tiny cell gets none."""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Dict

BENCH = Path(__file__).resolve().parents[1]

CLIP = {"embed_dim": 64, "image_resolution": 32, "vision_layers": 2, "vision_width": 128,
        "vision_patch_size": 8, "context_length": 77, "vocab_size": 49408,
        "transformer_width": 64, "transformer_heads": 2, "transformer_layers": 2}
SG2 = {"name": "tiny_sg2", "family": "stylegan2", "registry": "StyleGAN2_ffhq_d", "source": "test", "dtype": "float32",
       "reduced": [],
       "stylegan2": {"latent_size": 32, "label_size": 0, "mapping_layers": 2,
                     "mapping_lr_mul": 0.01, "channels": [16, 16, 16], "base_size": 4,
                     "data_channels": 3, "conv_block_size": 2, "kernel_size": 3,
                     "filter_taps": [1, 3, 3, 1], "mbstd_group_size": 4},
       "clip": CLIP,
       "search": {"algorithm": "nsga2", "n_var": 32, "dim_z": 32, "n_constr": 32,
                  "use_discriminator": True},
       "program": {"s2d_min_res": 16},
       "assumed": {"bias_std": 0.1, "noise_strength_std": 0.1, "layernorm_std": 0.1,
                   "image_std": 0.5, "image_std_rows": 4}}
BIGGAN = {"name": "tiny_biggan", "family": "biggan", "registry": "DeepMindBigGAN512", "source": "test",
          "dtype": "float32", "reduced": [],
          "biggan": {"z_dim": 16, "channel_width": 8, "num_classes": 10,
                     "layers": [[False, 2, 2], [True, 2, 1]], "attention_layer_position": 1,
                     "eps": 0.0001, "n_stats": 51, "output_dim": 8},
          "clip": CLIP,
          "search": {"algorithm": "ga", "n_var": 26, "dim_z": 16, "num_classes": 10,
                     "n_constr": 16, "use_discriminator": False},
          "program": {"s2d_min_res": 8},
          "assumed": {"bias_std": 0.1, "layernorm_std": 0.1, "embedding_std": 1.0,
                      "attention_gamma_mean": 0.5, "attention_gamma_std": 0.1,
                      "standing_stats_rows": 4}}
GPT2 = {"name": "tiny_gpt2", "family": "gpt2", "registry": "GPT2", "source": "test",
        "dtype": "float32", "reduced": [],
        "gpt2": {"vocab_size": 50257, "n_positions": 128, "n_embd": 64, "n_layer": 2,
                 "n_head": 2, "layer_norm_epsilon": 1e-5},
        "clip": CLIP,
        "search": {"algorithm": "ga", "n_var": 20, "dim_z": 20, "n_constr": 20,
                   "init_text": "the picture of", "max_tokens_len": 30, "max_text_len": 50,
                   "use_discriminator": False},
        "assumed": {"bias_std": 0.02, "layernorm_std": 0.1}}
TRAFFIC = {
    "search8": {"kind": "search", "pop": 8, "warmup_generations": 1, "profile_units": 1,
                "check_evaluations": 2, "check_window": 100, "check_block": 4},
    "serve2": {"kind": "serve", "pop": 8, "slots": 2, "chunk": 2, "requests": 2,
               "generations": 1000, "warmup_ticks": 1, "profile_units": 1,
               "check_evaluations": 2, "check_window": 100, "check_block": 8},
}
# the tiny configuration of each family and the tiny mix of each traffic kind
FAMILIES = {cfg["family"]: cfg["name"] for cfg in (SG2, BIGGAN, GPT2)}
MIXES = {t["kind"]: name for name, t in TRAFFIC.items()}
WORKLOADS = [
    {"name": "tiny_sg2.search8", "config": "tiny_sg2", "traffic": "search8", "chips": 1},
    {"name": "tiny_sg2.serve2", "config": "tiny_sg2", "traffic": "serve2", "chips": 1},
    {"name": "tiny_biggan.search8", "config": "tiny_biggan", "traffic": "search8", "chips": 1},
    {"name": "tiny_gpt2.search8", "config": "tiny_gpt2", "traffic": "search8", "chips": 1},
    {"name": "tiny_gpt2.serve2", "config": "tiny_gpt2", "traffic": "serve2", "chips": 1},
]
# float32 on both sides: the port and the reference differ by summation order
LIMITS = {"sim_gap": {"max": 1e-3}, "sim_gap_rms": {"max": 1e-3}, "hinge_gap_rms": {"max": 1e-3},
          "moved_rows": {"min": 1}}
# image to text's too: the port and the reference take the same argmax
DECODE_LIMITS = {"decode_margin": {"max": 1e-3}}


def stand_ins(bench: dict, source: Path = BENCH) -> Dict[str, str]:
    """Each cell of `bench` (read from the benchmark directory `source`)
    that has a stand-in, mapped to it: the tiny cell of the same family
    and traffic kind."""
    tiny = {(w["config"], w["traffic"]): w["name"] for w in WORKLOADS}
    out = {}
    for w in bench["workloads"]:
        fam = json.loads((source / "configs" / f"{w['config']}.json").read_text())["family"]
        kind = json.loads((source / "traffic" / f"{w['traffic']}.json").read_text())["kind"]
        key = (FAMILIES.get(fam), MIXES.get(kind))
        if key in tiny:
            out[w["name"]] = tiny[key]
    return out


def write(root: Path, source: Path = BENCH) -> dict:
    """The tiny benchmark under `root` (a `benchmark/` directory's layout)
    and its BENCHMARK.json contents, which it also writes beside it: the
    benchmark of the directory `source` (its metrics, readers and
    `BENCHMARK.json`) with its cells replaced by the tiny ones, each
    per-layer metric's list naming the stand-ins of its cells."""
    for sub in ("configs", "traffic", "limits"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(source / "metrics", root / "metrics", dirs_exist_ok=True)
    for cfg in (SG2, BIGGAN, GPT2):
        (root / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    for name, t in TRAFFIC.items():
        (root / "traffic" / f"{name}.json").write_text(json.dumps(t))
    for w in WORKLOADS:
        lim = {k: v for k, v in LIMITS.items()
               if not k.startswith("hinge") or w["config"] == "tiny_sg2"}
        if w["config"] == "tiny_gpt2":
            lim.update(DECODE_LIMITS)
        (root / "limits" / f"{w['name']}.json").write_text(json.dumps(lim))
    bench = json.loads((source.parent / "BENCHMARK.json").read_text())
    stands = stand_ins(bench, source)
    per_layer = [{**m, "workloads": list(dict.fromkeys(stands[w] for w in m["workloads"]
                                                       if w in stands))}
                 if "workloads" in m else m for m in bench["per_layer"]]
    bench = {**bench, "workloads": WORKLOADS, "per_layer": per_layer}
    (root.parent / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench
