"""Mixed-precision policy: fp32 parameters, bf16 compute, fp32 normalization.

Mirrors the JAX package's policy: matmul/conv inputs in the compute dtype,
LayerNorm statistics in fp32 (ops/norms.py). Frozen weights are cast to the
compute dtype once (`precast_params`), except the leaves a forward reads raw
in fp32, which each model names by key prefix.
"""

from __future__ import annotations

import dataclasses

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int32": torch.int32,
}


def resolve_dtype(d):
    if isinstance(d, str):
        return _DTYPES[d]
    return d


@dataclasses.dataclass(frozen=True)
class Policy:
    """param_dtype: storage; compute_dtype: matmul/conv inputs; norm in fp32."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def make(param_dtype="float32", compute_dtype="bfloat16") -> "Policy":
        return Policy(resolve_dtype(param_dtype), resolve_dtype(compute_dtype))

    def cast_compute(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype)


FP32 = Policy(torch.float32, torch.float32)
BF16 = Policy(torch.float32, torch.bfloat16)


def map_tree(fn, tree, path=()):
    """Apply fn(path, leaf) to every tensor leaf of nested dicts/lists."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, path + (i,)) for i, v in enumerate(tree))
    if isinstance(tree, torch.Tensor):
        return fn(path, tree)
    return tree


def precast_params(params, policy: Policy, exclude_prefixes: tuple = ()):
    """Cast every float leaf of a FROZEN parameter tree to the compute dtype,
    once, except leaves whose path holds a key starting with one of
    `exclude_prefixes` (the leaves a forward reads raw in fp32)."""
    def cast(path, leaf):
        if not leaf.is_floating_point():
            return leaf
        if any(isinstance(k, str) and k.startswith(exclude_prefixes)
               for k in path):
            return leaf
        return policy.cast_compute(leaf)

    return map_tree(cast, params)


def tree_to(tree, device):
    """Move every tensor leaf of a parameter tree to `device`."""
    return map_tree(lambda _, t: t.to(device), tree)
