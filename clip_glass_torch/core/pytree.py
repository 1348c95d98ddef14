"""Parameter trees on disk: flat dotted keys in an npz file.

The port's own copy of the JAX package's npz format (numpy only): nested
dicts and lists flatten to `a.b.0.c` keys, list indices becoming digit keys,
which `restore_lists` turns back into lists after `load_npz`.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

SEP = "."


def flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """Nested dict/list -> {dotted.key: leaf}; list indices become keys, so
    lists round-trip through unflatten as {'0': ..., '1': ...} dicts."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        key = f"{prefix}{SEP}{k}" if prefix else str(k)
        if isinstance(v, (dict, list, tuple)):
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split(SEP)
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def save_npz(path: str, tree) -> None:
    """Leaves: numpy arrays, scalars or CPU tensors of a numpy dtype."""
    flat = {k: np.asarray(v) for k, v in flatten(tree).items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        np.savez(f, **flat)


def load_npz(path: str) -> Dict[str, Any]:
    """The nested tree of numpy arrays (lists still as digit-keyed dicts)."""
    with np.load(path) as data:
        # bind each array once: NpzFile.__getitem__ decompresses per access
        flat = {k: data[k] for k in data.files}
    return unflatten(flat)


def restore_lists(tree):
    """Invert flatten's list->{'0': ...} encoding: any dict whose keys are
    all decimal strings becomes a list ordered by index (recursively)."""
    if isinstance(tree, dict):
        out = {k: restore_lists(v) for k, v in tree.items()}
        if out and all(k.isdigit() for k in out):
            return [out[k] for k in sorted(out, key=int)]
        return out
    return tree
