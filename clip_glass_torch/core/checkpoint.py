"""GA search checkpoint / resume.

The whole search state is small: population X, fitness F, the generation
counter and the state of the one torch.Generator every draw comes from. It
is saved as `ga_state.npz` at every save cadence, atomically, so that
`run_torch.py --resume` continues bit-exactly where the dump left off.

K searches batched in one run (evolve/batched.py, several `--target`) save
one file with a leading search axis: X [K, pop, n_var], F [K, pop, n_obj],
gen [K], `n_search` = K and the K generators' states stacked in
`rng_state` [K, S]. A file is continued only by a run of as many searches:
`load_state` refuses another K, and a single-search file for a batch or
the other way round (the JAX CLI instead starts afresh, cli.py:416-422).

The file is not interchangeable with the JAX package's: that one holds a JAX
PRNG key (`key`), whose stream the port cannot continue, where this one
holds `rng_state` (the generator's `get_state()`, uint8) and `rng_device`
(CPU and CUDA generators draw different streams from one state).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Union

import numpy as np
import torch

from clip_glass_torch.evolve.algorithm import GAState

STATE_FILE = "ga_state.npz"

Generators = Union[torch.Generator, Sequence[torch.Generator]]


def _batched(generators: Generators) -> bool:
    return not isinstance(generators, torch.Generator)


def save_state(state: GAState, generators: Generators, folder: str,
               config_name: str = "") -> str:
    """Write `<folder>/ga_state.npz`; `generators` is the search's generator
    (or a batch's K generators, with a batched `state`), in the state it has
    after `state.gen` generations."""
    path = os.path.join(folder, STATE_FILE)
    os.makedirs(folder, exist_ok=True)
    fields = dict(X=state.X.cpu().numpy(), F=state.F.cpu().numpy(),
                  gen=np.asarray(state.gen, np.int64), config=np.asarray(config_name))
    if _batched(generators):
        fields["n_search"] = np.asarray(len(generators), np.int64)
        fields["rng_state"] = np.stack([g.get_state().numpy() for g in generators])
        device = generators[0].device
    else:
        fields["rng_state"] = generators.get_state().numpy()
        device = generators.device
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **fields, rng_device=np.asarray(device.type))
    os.replace(tmp, path)  # atomic: never a torn checkpoint
    return path


def load_state(folder: str, generators: Generators) -> Optional[GAState]:
    """The saved state on the generators' device, with `generators` (one,
    or a batch's K) set to the saved generator states; None when there is
    no file. Raises ValueError for a file this search cannot continue."""
    path = os.path.join(folder, STATE_FILE)
    if not os.path.exists(path):
        return None
    batched = _batched(generators)
    dev = (generators[0] if batched else generators).device
    with np.load(path) as d:
        if "rng_state" not in d.files:
            why = (" (it holds a JAX PRNG key: written by clip_glass_tpu, whose "
                   "random stream cannot continue here)" if "key" in d.files else "")
            raise ValueError(f"{path} has no rng_state{why}; start the search "
                             "afresh without --resume")
        saved = str(d["rng_device"])
        if saved != dev.type:
            raise ValueError(
                f"{path} was written by a search on {saved!r}, this one runs on "
                f"{dev.type!r}: CPU and CUDA generators draw "
                "different streams, so the search cannot continue bit-exactly")
        k_saved = int(d["n_search"]) if "n_search" in d.files else 1
        k_run = len(generators) if batched else 1
        if k_saved != k_run or ("n_search" in d.files) != batched:
            raise ValueError(
                f"{path} holds {k_saved} batched search(es), this run has {k_run} "
                f"({'several targets' if batched else 'one target'}); resume with "
                "the targets it was written with, or start afresh without --resume")
        X = torch.from_numpy(d["X"]).to(dev)
        F = torch.from_numpy(d["F"]).to(dev)
        if batched:
            state = GAState(X=X, F=F, gen=tuple(int(g) for g in d["gen"]))
            for g, rng in zip(generators, d["rng_state"]):
                g.set_state(torch.from_numpy(rng))
        else:
            state = GAState(X=X, F=F, gen=int(d["gen"]))
            generators.set_state(torch.from_numpy(d["rng_state"]))
    return state


def checkpoint_config_name(folder: str) -> Optional[str]:
    path = os.path.join(folder, STATE_FILE)
    if not os.path.exists(path):
        return None
    with np.load(path) as d:
        return str(d["config"]) if "config" in d else None
