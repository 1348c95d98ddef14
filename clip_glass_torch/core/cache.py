"""Where the package builds its native libraries (the CUDA kernels of
ops/cuda.py, the BPE merge core of tokenizers/native.py).

In a checkout, or wherever the package's parent directory is writable:
`<parent>/build/clip_glass_torch`, which the repository's .gitignore lists.
Where it is not (an installed package in a read-only site-packages):
`$XDG_CACHE_HOME/clip_glass_torch`, or `~/.cache/clip_glass_torch` when that
variable is unset.
"""

from __future__ import annotations

import os
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent


def _writable(path: Path) -> bool:
    """Writable by this process, and not marked read-only: root passes
    `os.access` on any mode, so a directory with no write bit at all counts
    read-only for every user."""
    return os.access(path, os.W_OK | os.X_OK) and bool(path.stat().st_mode & 0o222)


def build_root(package: Path = PACKAGE) -> Path:
    """The directory the native libraries are built into (module docstring)."""
    local = package.parent / "build" / "clip_glass_torch"
    # the nearest existing directory on the way decides
    for path in (local, local.parent, package.parent):
        if path.is_dir():
            if _writable(path):
                return local
            break
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return Path(cache) / "clip_glass_torch"
