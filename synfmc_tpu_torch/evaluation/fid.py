"""Fréchet distance metrics: FID (images) and FVD (videos), the port of
synfmc_tpu/evaluation/fid.py.

The SynFMC paper reports FID/FVD as its generation-quality metrics; the
reference repo ships no implementation.  This module holds the exact
Fréchet distance math plus a pluggable feature-extractor seam: a user
supplies the standard extractor as TorchScript (InceptionV3 pool3 for FID,
I3D logits for FVD; neither ships with the repository).

    d^2 = |mu1 - mu2|^2 + Tr(S1 + S2 - 2 sqrt(S1 S2))

The trace term uses the eigenvalues of S1 @ S2 (similar to the symmetric
sqrt product, so its eigenvalues are real and non-negative up to noise),
with diagonal loading when their imaginary parts say the product is
ill-conditioned.  The statistics and the distance are float64 numpy on the
host; only the extractor runs on the device, the card unless the caller asks
for the CPU.
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np


def compute_statistics(features: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(N, D) features -> (mean (D,), covariance (D, D); rows = samples)."""
    f = np.asarray(features, np.float64)
    assert f.ndim == 2 and len(f) >= 2, f"need (N>=2, D) features, got {f.shape}"
    mu = f.mean(axis=0)
    sigma = np.cov(f, rowvar=False)
    return mu, np.atleast_2d(sigma)


def _trace_sqrt(prod: np.ndarray) -> tuple[float, np.ndarray]:
    eigvals = np.linalg.eigvals(prod)
    return float(np.sqrt(np.clip(eigvals.real, 0.0, None)).sum()), eigvals


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Squared Fréchet distance between two Gaussians (the FID/FVD score)."""
    mu1 = np.asarray(mu1, np.float64)
    mu2 = np.asarray(mu2, np.float64)
    sigma1 = np.atleast_2d(np.asarray(sigma1, np.float64))
    sigma2 = np.atleast_2d(np.asarray(sigma2, np.float64))
    diff = mu1 - mu2
    prod = sigma1 @ sigma2
    if not np.isfinite(prod).all():
        raise ValueError("non-finite covariance product")
    tr_sqrt, eigvals = _trace_sqrt(prod)
    if np.abs(eigvals.imag).max(initial=0.0) > eps * max(1.0, np.abs(eigvals.real).max(initial=0.0)):
        # ill-conditioned: diagonal loading, as the standard implementations do
        off = eps * np.eye(sigma1.shape[0])
        tr_sqrt, _ = _trace_sqrt((sigma1 + off) @ (sigma2 + off))
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2.0 * tr_sqrt)


def fid_from_features(feats_a: np.ndarray, feats_b: np.ndarray) -> float:
    """FID between two (N, D) feature sets (InceptionV3 pool3 for images)."""
    return frechet_distance(*compute_statistics(feats_a), *compute_statistics(feats_b))


def fvd_from_features(feats_a: np.ndarray, feats_b: np.ndarray) -> float:
    """FVD between two (N, D) video-level feature sets (I3D logits, 400-d,
    per the standard FVD protocol): the same Fréchet math as FID."""
    return fid_from_features(feats_a, feats_b)


def extract_features(batches: Iterable[np.ndarray],
                     extractor: Callable[[np.ndarray], np.ndarray]) -> np.ndarray:
    """Run ``extractor`` over batches and stack (N, D) features."""
    feats = [np.asarray(extractor(b)) for b in batches]
    return np.concatenate([f.reshape(len(f), -1) for f in feats], axis=0)


def load_torchscript_extractor(path: str, device=None) -> Callable[[np.ndarray], np.ndarray]:
    """A user-supplied TorchScript feature extractor (e.g. the standard FID
    InceptionV3 or FVD I3D export) as a numpy -> numpy callable.  Any module
    mapping a (N, ...) float tensor to (N, D) features works.  ``device``
    resolves as the entry points' does: the card unless ``"cpu"`` is asked
    (the JAX package's loader defaults to the CPU)."""
    import torch

    from synfmc_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    model = torch.jit.load(path, map_location=dev).eval()

    def run(batch: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            out = model(torch.from_numpy(np.ascontiguousarray(batch)).to(dev))
        return out.cpu().numpy()

    return run
