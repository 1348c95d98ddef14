"""ctypes binding of the native BPE merge core (clip_glass_torch/native/bpe_core.cpp).

At first use the core is compiled with `g++` into `build/clip_glass_torch/`
beside the package (the library's name carries a hash of the source, so an
edit rebuilds it), and never next to the source. A tokenizer's string-keyed
merge ranks become integer-id tables once; `NativeMerger.apply(symbol_ids)`
returns the merged ids. Without a working `g++` `get_native_merger` returns
None and the tokenizers keep to their pure-Python merge loop, which gives
the same ids: this is host code, not a kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" / "bpe_core.cpp"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_I32P = ctypes.POINTER(ctypes.c_int32)


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes())
    return (SOURCE.parent.parent.parent / "build" / "clip_glass_torch"
            / f"libbpe_core_{h.hexdigest()[:16]}.so")


def _build(out: Path) -> None:
    """Compile into a temporary name, then rename: processes that build at
    once never load a half-written library."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(SOURCE)], check=True,
                       capture_output=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


@lru_cache(maxsize=None)
def load_library() -> Optional[ctypes.CDLL]:
    """The bound core, built on first use; None when it cannot be built (no
    `g++`, or no source beside the package)."""
    try:
        out = library_path()
        if not out.exists():
            _build(out)
        lib = ctypes.CDLL(str(out))
    except (OSError, subprocess.CalledProcessError):
        return None
    lib.bpe_create.restype = ctypes.c_void_p
    lib.bpe_create.argtypes = [_I32P, _I32P, _I32P, ctypes.c_int32]
    lib.bpe_free.restype = None
    lib.bpe_free.argtypes = [ctypes.c_void_p]
    lib.bpe_apply.restype = ctypes.c_int32
    lib.bpe_apply.argtypes = [ctypes.c_void_p, _I32P, ctypes.c_int32, _I32P,
                              ctypes.c_int32]
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_I32P)


class NativeMerger:
    """Greedy lowest-rank-first BPE merge over integer symbol ids."""

    def __init__(self, lib: ctypes.CDLL, merges: Sequence[Tuple[int, int, int]]):
        """merges: [(left_id, right_id, merged_id)] in rank order."""
        self._lib = lib
        table = np.asarray(merges, np.int32).reshape(-1, 3)
        cols = [np.ascontiguousarray(table[:, i]) for i in range(3)]
        self._handle = lib.bpe_create(*(_ptr(c) for c in cols), len(table))

    def apply(self, symbol_ids: Sequence[int]) -> List[int]:
        arr = np.asarray(symbol_ids, np.int32)
        out = np.empty(max(len(arr), 1), np.int32)  # merging never lengthens
        m = self._lib.bpe_apply(self._handle, _ptr(arr), len(arr), _ptr(out), len(out))
        if m < 0:
            raise RuntimeError("bpe_apply: output buffer too small")
        return out[:m].tolist()

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.bpe_free(self._handle)
            self._handle = None


def get_native_merger(encoder: Dict[str, int],
                      bpe_ranks: Dict[Tuple[str, str], int]) -> Optional[NativeMerger]:
    """The merger for a tokenizer's tables, or None when the core cannot be
    built. Merges whose operands or result have no id are skipped (none for
    GPT-2; CLIP's truncated merge list has an id for every one)."""
    lib = load_library()
    if lib is None:
        return None
    merges = []
    for (a, b), _ in sorted(bpe_ranks.items(), key=lambda kv: kv[1]):
        ia, ib, iab = encoder.get(a), encoder.get(b), encoder.get(a + b)
        if ia is not None and ib is not None and iab is not None:
            merges.append((ia, ib, iab))
    return NativeMerger(lib, merges)
