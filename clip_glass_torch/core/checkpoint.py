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

Under a process group (parallel.distributed) every rank holds the same
state; rank 0 writes the file and every rank waits for it (a barrier), so
that a rank may read it next; every rank loads. `save_state_dcp` /
`load_state_dcp` keep the same state through torch.distributed.checkpoint
(the JAX package's orbax backend, core/checkpoint.py:60-82), a directory
every rank takes part in writing.
"""

from __future__ import annotations

import contextlib
import os
import warnings
from typing import Optional, Sequence, Union

import numpy as np
import torch

from clip_glass_torch.evolve.algorithm import GAState
from clip_glass_torch.parallel import distributed as dist

STATE_FILE = "ga_state.npz"
DCP_DIR = "dcp_state"

Generators = Union[torch.Generator, Sequence[torch.Generator]]


def _batched(generators: Generators) -> bool:
    return not isinstance(generators, torch.Generator)


def save_state(state: GAState, generators: Generators, folder: str,
               config_name: str = "") -> str:
    """Write `<folder>/ga_state.npz`; `generators` is the search's generator
    (or a batch's K generators, with a batched `state`), in the state it has
    after `state.gen` generations. Under a process group rank 0 writes and
    every rank returns once the file is there."""
    path = os.path.join(folder, STATE_FILE)
    if dist.is_primary():
        os.makedirs(folder, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **_fields(state, generators, config_name))
        os.replace(tmp, path)  # atomic: never a torn checkpoint
    dist.barrier()
    return path


def _fields(state: GAState, generators: Generators, config_name: str) -> dict:
    """The checkpoint's arrays: the state, the generators' states, the
    config's name."""
    fields = dict(X=state.X.cpu().numpy(), F=state.F.cpu().numpy(),
                  gen=np.asarray(state.gen, np.int64), config=np.asarray(config_name))
    if _batched(generators):
        fields["n_search"] = np.asarray(len(generators), np.int64)
        fields["rng_state"] = np.stack([g.get_state().numpy() for g in generators])
        device = generators[0].device
    else:
        fields["rng_state"] = generators.get_state().numpy()
        device = generators.device
    fields["rng_device"] = np.asarray(device.type)
    return fields


def load_state(folder: str, generators: Generators) -> Optional[GAState]:
    """The saved state on the generators' device, with `generators` (one,
    or a batch's K) set to the saved generator states; None when there is
    no file. Raises ValueError for a file this search cannot continue."""
    path = os.path.join(folder, STATE_FILE)
    if not os.path.exists(path):
        return None
    with np.load(path) as d:
        return _restore(path, dict(d), generators)


def _restore(path: str, d: dict, generators: Generators) -> GAState:
    """The state of checkpoint arrays `d` (read from `path`), with the
    generators set; raises ValueError for one this search cannot continue."""
    batched = _batched(generators)
    dev = (generators[0] if batched else generators).device
    if "rng_state" not in d:
        why = (" (it holds a JAX PRNG key: written by clip_glass_tpu, whose "
               "random stream cannot continue here)" if "key" in d else "")
        raise ValueError(f"{path} has no rng_state{why}; start the search "
                         "afresh without --resume")
    saved = str(d["rng_device"])
    if saved != dev.type:
        raise ValueError(
            f"{path} was written by a search on {saved!r}, this one runs on "
            f"{dev.type!r}: CPU and CUDA generators draw "
            "different streams, so the search cannot continue bit-exactly")
    k_saved = int(d["n_search"]) if "n_search" in d else 1
    k_run = len(generators) if batched else 1
    if k_saved != k_run or ("n_search" in d) != batched:
        raise ValueError(
            f"{path} holds {k_saved} batched search(es), this run has {k_run} "
            f"({'several targets' if batched else 'one target'}); resume with "
            "the targets it was written with, or start afresh without --resume")
    X = torch.as_tensor(np.asarray(d["X"])).to(dev)
    F = torch.as_tensor(np.asarray(d["F"])).to(dev)
    if batched:
        for g, rng in zip(generators, np.asarray(d["rng_state"])):
            g.set_state(torch.from_numpy(rng))
        return GAState(X=X, F=F, gen=tuple(int(g) for g in np.asarray(d["gen"])))
    generators.set_state(torch.from_numpy(np.asarray(d["rng_state"])))
    return GAState(X=X, F=F, gen=int(d["gen"]))


# ------------------------------------------------------------ dcp

@contextlib.contextmanager
def _single_process_quiet():
    """Without a process group dcp warns that it saves or loads in one
    process, which is what it is asked to do here."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        yield


def save_state_dcp(state: GAState, generators: Generators, folder: str,
                   config_name: str = "") -> str:
    """The npz checkpoint's arrays written through
    torch.distributed.checkpoint into `<folder>/dcp_state/` (every rank of a
    process group calls it; the state is replicated, so one rank's copy is
    written). Returns the directory."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(os.path.join(folder, DCP_DIR))
    fields = {k: torch.as_tensor(v) if v.dtype.kind in "biuf" else v.item()
              for k, v in _fields(state, generators, config_name).items()}
    with _single_process_quiet():
        dcp.save(fields, checkpoint_id=path)
    dist.barrier()
    return path


def load_state_dcp(folder: str, generators: Generators) -> Optional[GAState]:
    """`load_state` of a `save_state_dcp` directory; None when there is none."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(os.path.join(folder, DCP_DIR))
    if not os.path.isdir(path):
        return None
    meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    fields = {k: (torch.empty(tuple(m.size), dtype=m.properties.dtype)
                  if hasattr(m, "size") else None)
              for k, m in meta.items()}
    with _single_process_quiet():
        dcp.load(fields, checkpoint_id=path)
    d = {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in fields.items()}
    return _restore(path, d, generators)


def checkpoint_config_name(folder: str) -> Optional[str]:
    path = os.path.join(folder, STATE_FILE)
    if not os.path.exists(path):
        return None
    with np.load(path) as d:
        return str(d["config"]) if "config" in d else None
