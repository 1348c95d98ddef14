"""Memory from shapes alone: trees built on the `meta` device, and a tracker
of the bytes a computation holds at its peak.

The JAX package sizes a full-size step by compiling it against
ShapeDtypeStructs and reading XLA's memory analysis
(__graft_entry__.dryrun_multichip). Eager PyTorch has no compiled program
to ask; instead the same computation runs on `meta` tensors, which carry
shapes, dtypes and strides but no data, and `PeakMemory` counts the bytes
of every storage it creates while that storage is alive. The kernel
wrappers give meta tensors their kernel's output alone (ops/cuda.py,
`dispatch`), so the count is what the card holds, not what the plain
versions would.

- `abstract_construction()`: while it is active, every tensor factory
  (`torch.randn`, `torch.zeros`, `torch.tensor`, ...) makes a meta tensor
  and ignores its generator: an init function builds its tree at the real
  shapes and dtypes with no random draw.
- `PeakMemory`: a TorchDispatchMode. Each new output storage of an op adds
  its bytes, and a weak-reference finalizer on the storage takes them off
  when the storage dies (PyTorch keeps a storage's Python object alive as
  long as the storage, so a tensor autograd saved counts until the graph
  lets it go). It works on meta and on real tensors alike.

Bytes are counted twice, as the CUDA caching allocator's statistics count
them: as requested (`requested_bytes` in `torch.cuda.memory_stats`) and as
the allocator's blocks hold them (`allocated_bytes`, what
`torch.cuda.max_memory_allocated` reads), each storage rounded up to the
allocator's block size (`allocator_bytes`). The libraries' workspaces
(cuBLAS, cuDNN) are no op's output and stay unseen: parallel/dryrun.py
adds a margin for them.
"""

from __future__ import annotations

import dataclasses
import weakref
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakIdKeyDictionary

META = torch.device("meta")
# the factories that take a device (the init functions' and the draws')
FACTORIES = frozenset({
    torch.empty, torch.empty_strided, torch.zeros, torch.ones, torch.full, torch.tensor,
    torch.as_tensor, torch.arange, torch.linspace, torch.eye, torch.randn, torch.rand,
    torch.randint, torch.randperm, torch.normal, torch.scalar_tensor})


class abstract_construction(TorchFunctionMode):
    """Tensor factories make meta tensors (their generator dropped)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if func in FACTORIES:
            kwargs["device"] = META
            kwargs.pop("generator", None)
        return func(*args, **kwargs)


def is_abstract(weights) -> bool:
    """weights="abstract": shapes only (the JAX package's name)."""
    return weights == "abstract"


# The CUDA caching allocator hands out blocks in multiples of 512 bytes and
# none for an empty storage (c10/cuda/CUDACachingAllocator.cpp: kMinBlockSize,
# round_size, with PYTORCH_CUDA_ALLOC_CONF's roundup_power2_divisions unset).
ALLOCATOR_BLOCK = 512


def allocator_bytes(n: int) -> int:
    """The bytes the caching allocator's block holds for a request of n."""
    return -(-n // ALLOCATOR_BLOCK) * ALLOCATOR_BLOCK


def tree_bytes(tree, requested: bool = False) -> int:
    """The bytes of a tree's distinct storages (dicts, lists, tuples,
    NamedTuples and dataclasses of tensors), each as the allocator's block
    holds it, or as requested."""
    storages = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        storages[id(st)] = st
    size = (lambda n: n) if requested else allocator_bytes
    return sum(size(st.nbytes()) for st in storages.values())


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


class PeakMemory(TorchDispatchMode):
    """`with PeakMemory() as m: ...` then `m.peak`: the most bytes of
    storages created inside the block that were alive at once, each rounded
    to the allocator's block (`allocator_bytes`); `m.live`: those still
    alive; `m.requested_peak`, `m.requested_live`: the same unrounded.
    Storages that existed before (the weights, the state) are not counted:
    add them (`tree_bytes`)."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self.requested_live = self.requested_peak = 0
        self._seen = WeakIdKeyDictionary()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        # an output on an input's storage (a view, a no-op cast, an in-place
        # op) allocates nothing: a storage from before the block stays out.
        # lift_fresh's input is a tensor that torch.tensor() has just made.
        given = set() if func is torch.ops.aten.lift_fresh.default else {
            id(a.untyped_storage()) for a in tree_leaves((args, kwargs))
            if isinstance(a, torch.Tensor)}
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and id(t.untyped_storage()) not in given:
                self.track(t)
        return out

    def track(self, t: torch.Tensor) -> None:
        """Count t's storage from now until it dies (once)."""
        st = t.untyped_storage()
        if st in self._seen:
            return
        asked = st.nbytes()
        n = allocator_bytes(asked)
        self._seen[st] = n
        self.live += n
        self.requested_live += asked
        self.peak = max(self.peak, self.live)
        self.requested_peak = max(self.requested_peak, self.requested_live)
        weakref.finalize(st, self._free, n, asked)

    def _free(self, n: int, asked: int) -> None:
        self.live -= n
        self.requested_live -= asked

