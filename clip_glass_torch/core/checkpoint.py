"""GA search checkpoint / resume.

The whole search state is small: population X, fitness F, the generation
counter and the state of the one torch.Generator every draw comes from. It
is saved as `ga_state.npz` at every save cadence, atomically, so that
`run_torch.py --resume` continues bit-exactly where the dump left off.

The file is not interchangeable with the JAX package's: that one holds a JAX
PRNG key (`key`), whose stream the port cannot continue, where this one
holds `rng_state` (the generator's `get_state()`, uint8) and `rng_device`
(CPU and CUDA generators draw different streams from one state).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from clip_glass_torch.evolve.algorithm import GAState

STATE_FILE = "ga_state.npz"


def save_state(state: GAState, generator: torch.Generator, folder: str,
               config_name: str = "") -> str:
    """Write `<folder>/ga_state.npz`; `generator` is the search's, in the
    state it has after `state.gen` generations."""
    path = os.path.join(folder, STATE_FILE)
    os.makedirs(folder, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, X=state.X.cpu().numpy(), F=state.F.cpu().numpy(),
                 gen=np.asarray(state.gen, np.int64), config=np.asarray(config_name),
                 rng_state=generator.get_state().numpy(),
                 rng_device=np.asarray(generator.device.type))
    os.replace(tmp, path)  # atomic: never a torn checkpoint
    return path


def load_state(folder: str, generator: torch.Generator) -> Optional[GAState]:
    """The saved state on the generator's device, with `generator` set to the
    saved generator state; None when there is no file. Raises ValueError for
    a file this search cannot continue."""
    path = os.path.join(folder, STATE_FILE)
    if not os.path.exists(path):
        return None
    with np.load(path) as d:
        if "rng_state" not in d.files:
            why = (" (it holds a JAX PRNG key: written by clip_glass_tpu, whose "
                   "random stream cannot continue here)" if "key" in d.files else "")
            raise ValueError(f"{path} has no rng_state{why}; start the search "
                             "afresh without --resume")
        saved = str(d["rng_device"])
        if saved != generator.device.type:
            raise ValueError(
                f"{path} was written by a search on {saved!r}, this one runs on "
                f"{generator.device.type!r}: CPU and CUDA generators draw "
                "different streams, so the search cannot continue bit-exactly")
        dev = generator.device
        state = GAState(X=torch.from_numpy(d["X"]).to(dev),
                        F=torch.from_numpy(d["F"]).to(dev), gen=int(d["gen"]))
        generator.set_state(torch.from_numpy(d["rng_state"]))
    return state


def checkpoint_config_name(folder: str) -> Optional[str]:
    path = os.path.join(folder, STATE_FILE)
    if not os.path.exists(path):
        return None
    with np.load(path) as d:
        return str(d["config"]) if "config" in d else None
