"""Helpers shared by the tests that hold clip_glass_torch against clip_glass_tpu:
numpy <-> torch conversion, the HWIO -> OIHW weight transpose, and a
comparison relative to the output's scale."""

import numpy as np
import torch


def T(a) -> torch.Tensor:
    """numpy/JAX array -> fp32 CPU tensor (a copy)."""
    return torch.from_numpy(np.array(np.asarray(a), dtype=np.float32))


def N(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def oihw(w_hwio) -> torch.Tensor:
    return T(w_hwio).permute(3, 2, 0, 1).contiguous()


def assert_close_scaled(got, want, rtol: float):
    """|got - want| <= rtol * (|want| + max|want|): a relative tolerance that
    also covers entries far below the tensor's scale."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)
