"""Metric formulas (a copy of `pasta_gan_tpu/metrics/formulas.py`, numpy/scipy on the host).

Exact ports of the reference math, kept here so the port never imports the
JAX package; the same inputs give the same floats as the JAX module:
FID (`metrics/frechet_inception_distance.py:20-39`), KID
(`kernel_inception_distance.py:18-43`), IS (`inception_score.py:18-36`),
precision/recall (`precision_recall.py:19-61`), and the PPL reduction
(`perceptual_path_length.py:165-170`).  All operate on feature/probability
matrices; feature extraction is the caller's concern (extractors.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.linalg


def fid_from_stats(mu_real, sigma_real, mu_gen, sigma_gen) -> float:
    m = np.square(mu_gen - mu_real).sum()
    # the JAX module passes disp=False, which SciPy 1.18 removed; the matrix is the same
    s = scipy.linalg.sqrtm(np.dot(sigma_gen, sigma_real))
    return float(np.real(m + np.trace(sigma_gen + sigma_real - s * 2)))


def kid_from_features(
    real_features: np.ndarray,
    gen_features: np.ndarray,
    num_subsets: int = 100,
    max_subset_size: int = 1000,
    rng: Optional[np.random.Generator] = None,
) -> float:
    """Polynomial-kernel MMD averaged over random subsets."""
    rng = rng or np.random.default_rng()
    n = real_features.shape[1]
    m = min(min(real_features.shape[0], gen_features.shape[0]), max_subset_size)
    t = 0.0
    for _ in range(num_subsets):
        x = gen_features[rng.choice(gen_features.shape[0], m, replace=False)]
        y = real_features[rng.choice(real_features.shape[0], m, replace=False)]
        a = (x @ x.T / n + 1) ** 3 + (y @ y.T / n + 1) ** 3
        b = (x @ y.T / n + 1) ** 3
        t += (a.sum() - np.diag(a).sum()) / (m - 1) - b.sum() * 2 / m
    return float(t / num_subsets / m)


def inception_score_from_probs(gen_probs: np.ndarray, num_splits: int = 10) -> Tuple[float, float]:
    num_gen = gen_probs.shape[0]
    scores = []
    for i in range(num_splits):
        part = gen_probs[i * num_gen // num_splits : (i + 1) * num_gen // num_splits]
        kl = part * (np.log(part) - np.log(np.mean(part, axis=0, keepdims=True)))
        kl = np.mean(np.sum(kl, axis=1))
        scores.append(np.exp(kl))
    return float(np.mean(scores)), float(np.std(scores))


def _pairwise_sq_dist(row: np.ndarray, col: np.ndarray, col_batch: int = 10000) -> np.ndarray:
    """||r - c||^2 in column batches (reference compute_distances)."""
    out = []
    r2 = np.sum(np.square(row), axis=1, keepdims=True)
    for i in range(0, col.shape[0], col_batch):
        c = col[i : i + col_batch]
        c2 = np.sum(np.square(c), axis=1)[None, :]
        d = r2 + c2 - 2.0 * row @ c.T
        out.append(np.maximum(d, 0.0))
    return np.concatenate(out, axis=1)


def precision_recall_from_features(
    real_features: np.ndarray,
    gen_features: np.ndarray,
    nhood_size: int = 3,
    row_batch_size: int = 10000,
    col_batch_size: int = 10000,
) -> Tuple[float, float]:
    """k-NN manifold precision/recall (reference precision_recall.py:39-61)."""
    results = {}
    for name, manifold, probes in [
        ("precision", real_features, gen_features),
        ("recall", gen_features, real_features),
    ]:
        kth = []
        for i in range(0, manifold.shape[0], row_batch_size):
            batch = manifold[i : i + row_batch_size]
            dist = _pairwise_sq_dist(batch, manifold, col_batch_size)
            # kthvalue(nhood_size+1): the (k+1)-th smallest (1-indexed), which
            # skips the zero self-distance.
            kth.append(np.partition(dist, nhood_size, axis=1)[:, nhood_size])
        kth = np.concatenate(kth)
        pred = []
        for i in range(0, probes.shape[0], row_batch_size):
            batch = probes[i : i + row_batch_size]
            dist = _pairwise_sq_dist(batch, manifold, col_batch_size)
            pred.append((dist <= kth[None, :]).any(axis=1))
        results[name] = float(np.concatenate(pred).mean())
    return results["precision"], results["recall"]


def ppl_from_distances(dist: np.ndarray) -> float:
    """1%-99% trimmed mean of per-sample path lengths (ppl.py:165-170)."""
    lo = np.percentile(dist, 1, method="lower")
    hi = np.percentile(dist, 99, method="higher")
    return float(np.extract(np.logical_and(dist >= lo, dist <= hi), dist).mean())


def slerp(a: np.ndarray, b: np.ndarray, t) -> np.ndarray:
    """Spherical interpolation (ppl.py:24-33)."""
    a = a / np.linalg.norm(a, axis=-1, keepdims=True)
    b = b / np.linalg.norm(b, axis=-1, keepdims=True)
    d = np.sum(a * b, axis=-1, keepdims=True)
    p = t * np.arccos(np.clip(d, -1.0, 1.0))
    c = b - d * a
    c = c / np.linalg.norm(c, axis=-1, keepdims=True)
    out = a * np.cos(p) + c * np.sin(p)
    return out / np.linalg.norm(out, axis=-1, keepdims=True)
