"""Frechet Inception Distance.

Behavioral reference: stylegan2/metrics/fid.py — pooled features for N reals
and N fakes, Frechet distance via matrix sqrt (159-210, scipy sqrtm at 208).

The feature extractor is pluggable: the reference hardwires the pytorch-fid
InceptionV3 (stylegan2/external_models/inception.py; here
`metrics.inception.features` on converted or random weights); any callable
[B,3,H,W] in [0,1] -> [B,D] works (e.g. the package's CLIP image tower,
"CLIP-FID"). Its output may be a numpy array or a tensor on any device. The
port's own copy of the JAX package's `metrics/fid.py` (numpy and scipy).
"""

from __future__ import annotations

from typing import Callable, Iterator

import warnings

import numpy as np
import scipy.linalg


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """d^2 = |mu1-mu2|^2 + Tr(s1 + s2 - 2 sqrt(s1 s2))
    (reference stylegan2/metrics/fid.py:202-210)."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    # no `disp`: SciPy 1.18 drops it (the JAX package's call passes
    # disp=False); without it sqrtm returns the matrix alone on every version
    covmean = scipy.linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def _stats(feats: np.ndarray):
    mu = feats.mean(axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, np.atleast_2d(sigma)


class FID:
    """FID between a real-image iterator and generated samples
    (reference stylegan2/metrics/fid.py:29-210)."""

    def __init__(self, feature_fn: Callable, num_samples: int = 50000,
                 batch_size: int = 32):
        self.feature_fn = feature_fn
        self.num_samples = num_samples
        self.batch_size = batch_size
        self._real_stats = None

    def _collect(self, batches: Iterator[np.ndarray]) -> np.ndarray:
        feats, seen = [], 0
        for batch in batches:
            f = self.feature_fn(batch)
            if hasattr(f, "detach"):   # a tensor, maybe on the card
                f = f.detach().cpu().numpy()
            f = np.asarray(f)
            feats.append(f)
            seen += len(f)
            if seen >= self.num_samples:
                break
        if not feats:
            raise ValueError("FID: the batch iterator yielded no samples")
        if seen < self.num_samples:
            # a silently undersampled FID is not comparable to an FID-N:
            # small-sample covariance biases the score upward
            warnings.warn(
                f"FID: iterator exhausted at {seen} samples "
                f"(num_samples={self.num_samples}); statistics are "
                f"computed over {seen} and the score is not an "
                f"FID-{self.num_samples}", stacklevel=3)
        return np.concatenate(feats)[: self.num_samples]

    def set_real_stats(self, real_batches: Iterator[np.ndarray]):
        self._real_stats = _stats(self._collect(real_batches))
        return self

    def evaluate(self, fake_batches: Iterator[np.ndarray]) -> float:
        assert self._real_stats is not None, "call set_real_stats first"
        mu_f, sigma_f = _stats(self._collect(fake_batches))
        mu_r, sigma_r = self._real_stats
        return frechet_distance(mu_r, sigma_r, mu_f, sigma_f)
