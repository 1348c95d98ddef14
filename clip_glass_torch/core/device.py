"""The device rule of the package's entry points.

Entry points take `device` and default to the GPU. Without a GPU they raise
unless the caller asked for the CPU: a search never carries on quietly on
the host.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@lru_cache(maxsize=None)
def _constant(make, args, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.as_tensor(make(*args), dtype=dtype, device=device)


def constant(make, *args, device, dtype=torch.float32) -> torch.Tensor:
    """`make(*args)` (a numpy array built from hashable arguments) as a tensor
    on `device`, built and copied once per device and dtype, and shared by
    every caller: read it, never write it. A copy from host memory to the GPU
    waits for the stream, so the hot path never makes one."""
    return _constant(make, args, torch.device(device), dtype)
