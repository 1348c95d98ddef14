"""clip.load-style convenience API (reference clip/clip.py:56-122).

`load` returns a `LoadedCLIP` with `encode_image` / `encode_text` and the
host-side `preprocess`, as `model, preprocess = clip.load(...)` does. It
takes `"random[:seed]"` or a converted `.npz` with its `_cfg.json` sidecar
(the reference's `.pt` files are ROADMAP item 14). The model names are the
reference's registry (clip/clip.py:17-21); with no download here, their
hashes check local files.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np
import torch

from clip_glass_torch.core.device import resolve_device
from clip_glass_torch.core.dtypes import FP32, Policy, precast_params, tree_to
from clip_glass_torch.models.clip import model as clip_model
from clip_glass_torch.ops.resize import clip_preprocess_pil
from clip_glass_torch.tokenizers import tokenize  # noqa: F401  (re-export)
from clip_glass_torch.weights.load import load_clip

# the sha256 of each official checkpoint, embedded in its download URL and
# checked after a download (reference clip/clip.py:17-53)
MODEL_SHA256 = {
    "RN50": "afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762",
    "ViT-B/32": "40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af",
}


def available_models():
    return list(MODEL_SHA256)


def verify_checkpoint(path: str, model_name: str) -> bool:
    """Whether a local checkpoint has the official sha256 (reference
    clip/clip.py:45-53)."""
    expected = MODEL_SHA256.get(model_name)
    if expected is None:
        raise KeyError(f"unknown model {model_name!r}; see available_models()")
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest() == expected


@dataclasses.dataclass
class LoadedCLIP:
    params: dict
    cfg: clip_model.CLIPConfig
    policy: Policy
    device: torch.device

    @torch.inference_mode()
    def encode_image(self, images) -> torch.Tensor:
        return clip_model.encode_image(self.params, torch.as_tensor(images, device=self.device),
                                       self.cfg, self.policy)

    @torch.inference_mode()
    def encode_text(self, text_ids) -> torch.Tensor:
        return clip_model.encode_text(self.params, torch.as_tensor(text_ids, device=self.device),
                                      self.cfg, self.policy)

    def preprocess(self, pil_image) -> np.ndarray:
        return clip_preprocess_pil(pil_image, self.cfg.image_resolution)


def load(name_or_path: str = "random:0", policy: Optional[Policy] = None,
         cfg: Optional[clip_model.CLIPConfig] = None, device=None) -> LoadedCLIP:
    """CLIP on `device` (the GPU unless the caller asks for the CPU), its
    frozen weights staged in the policy's compute dtype."""
    policy = policy or FP32
    params, cfg = load_clip(name_or_path, cfg)
    dev = resolve_device(device)
    params = tree_to(precast_params(params, policy, clip_model.PRECAST_EXCLUDE), dev)
    return LoadedCLIP(params, cfg, policy, dev)
