"""IOI Pattern Entropy (JAX counterpart: etude_tpu/evaluation/metrics/ipe.py).

Clips IOIs to [min_ioi, max_ioi], K-Means-quantizes the log-IOIs into
symbols, and scores the Shannon entropy of the n-gram distribution. Higher =
less predictable rhythm.

The JAX package quantizes with scikit-learn's `KMeans(n_clusters=k,
random_state=42, n_init="auto")`, which is not installed where the port
runs. `kmeans_labels` is the port's own k-means in numpy, following
scikit-learn 1.9's `KMeans.fit` on dense float64 data step by step, so that
it finds the same partition: the data centred on its mean; k-means++
seeding (`_kmeans_plusplus`) with 2 + ⌊ln k⌋ local trials, the candidates
drawn by `searchsorted` on the cumulative potential; Lloyd iterations
(`_kmeans_single_lloyd`) with the tolerance scaled by the data's variance,
the distances as ‖c‖² − 2x·c, the first nearest centre winning, empty
clusters relocated to the farthest points and centre shifts for
convergence; and one more assignment after a convergence by tolerance.
"""

from __future__ import annotations

from collections import Counter
from pathlib import Path

import numpy as np

from .base_metric import get_onsets_from_file

_KMEANS_TOL, _KMEANS_MAX_ITER = 1e-4, 300


def _sq_distances(centers: np.ndarray, X: np.ndarray, x_sq: np.ndarray) -> np.ndarray:
    """[c, n] squared distances as scikit-learn's `_euclidean_distances`
    computes them for float64: −2·C·Xᵀ + ‖c‖² + ‖x‖², clipped at 0."""
    d = -2 * (centers @ X.T)
    d += np.einsum("ij,ij->i", centers, centers)[:, None]
    d += x_sq[None, :]
    return np.maximum(d, 0, out=d)


def _kmeans_plusplus(X, n_clusters, x_sq, weights, rng) -> np.ndarray:
    n_local_trials = 2 + int(np.log(n_clusters))
    centers = np.empty((n_clusters, X.shape[1]), dtype=X.dtype)
    center_id = rng.choice(X.shape[0], p=weights / weights.sum())
    centers[0] = X[center_id]
    closest = _sq_distances(centers[0, np.newaxis], X, x_sq)
    pot = closest @ weights
    for c in range(1, n_clusters):
        rand_vals = rng.uniform(size=n_local_trials) * pot
        ids = np.searchsorted(np.cumsum(weights * closest), rand_vals)
        np.clip(ids, None, closest.size - 1, out=ids)
        dist = _sq_distances(X[ids], X, x_sq)
        np.minimum(closest, dist, out=dist)
        pots = dist @ weights.reshape(-1, 1)
        best = np.argmin(pots)
        pot = pots[best]
        closest = dist[best]
        centers[c] = X[ids[best]]
    return centers


def _assign(X: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """The nearest centre of each point, by ‖c‖² − 2x·c (scikit-learn's
    `_update_chunk_dense`); the first of equal distances wins."""
    dist = np.einsum("ij,ij->i", centers, centers)[None, :] + (-2.0) * (X @ centers.T)
    return np.argmin(dist, axis=1).astype(np.int32)


def _lloyd_step(X, weights, centers, labels):
    """One Lloyd iteration (`lloyd_iter_chunked_dense`): assignment, sums,
    empty clusters relocated, averages; returns (new centres, shifts)."""
    k = centers.shape[0]
    labels[:] = _assign(X, centers)
    sums = np.stack([np.bincount(labels, weights=X[:, f] * weights, minlength=k)
                     for f in range(X.shape[1])], axis=1)
    mass = np.bincount(labels, weights=weights, minlength=k)

    empty = np.where(np.equal(mass, 0))[0]
    if empty.size:
        dist = ((X - centers[labels]) ** 2).sum(axis=1)
        far = np.argpartition(dist, -empty.size)[:-empty.size - 1:-1]
        if np.max(dist) != 0:
            for new_id, i in zip(empty, far):
                w, old_id = weights[i], labels[i]
                sums[old_id] -= X[i] * w
                sums[new_id] = X[i] * w
                mass[new_id] = w
                mass[old_id] -= w

    biggest = np.argmax(mass)
    for j in range(k):   # in place and in order, as the reference loop
        if mass[j] > 0:
            sums[j] *= 1.0 / mass[j]
        else:
            sums[j] = sums[biggest]
    shifts = np.sqrt(((sums - centers) ** 2).sum(axis=1))
    return sums, shifts


def kmeans_labels(x: np.ndarray, n_clusters: int, seed: int = 42) -> np.ndarray:
    """Labels of `KMeans(n_clusters, random_state=seed, n_init="auto")
    .fit(x)` for x [n, d] float64, without scikit-learn."""
    X = np.array(x, dtype=np.float64, order="C")
    tol = np.mean(np.var(X, axis=0)) * _KMEANS_TOL
    X -= X.mean(axis=0)
    x_sq = np.einsum("ij,ij->i", X, X)
    weights = np.ones(X.shape[0], dtype=X.dtype)
    rng = np.random.RandomState(seed)
    centers = _kmeans_plusplus(X, n_clusters, x_sq, weights, rng)

    labels = np.full(X.shape[0], -1, dtype=np.int32)
    labels_old = labels.copy()
    for _ in range(_KMEANS_MAX_ITER):
        centers_new, shifts = _lloyd_step(X, weights, centers, labels)
        centers = centers_new
        if np.array_equal(labels, labels_old):
            return labels
        if (shifts ** 2).sum() <= tol:
            break
        labels_old[:] = labels
    # Converged by tolerance or out of iterations: assign once more so that
    # the labels match the centres.
    return _assign(X, centers)


class IPECalculator:
    def __init__(
        self,
        n_gram: int = 8,
        n_clusters: int = 8,
        min_ioi: float = 0.0625,
        max_ioi: float = 4.0,
        **_,
    ):
        self.n_gram = n_gram
        self.n_clusters = n_clusters
        self.min_ioi = min_ioi
        self.max_ioi = max_ioi

    def _quantize(self, iois: np.ndarray) -> np.ndarray:
        log_ioi = np.log(iois).reshape(-1, 1)
        k = min(self.n_clusters, len(np.unique(log_ioi)))
        if k < 2:
            return np.array([])
        return kmeans_labels(log_ioi, k, seed=42)

    def calculate(self, file_path: Path) -> dict:
        onsets = get_onsets_from_file(file_path)
        if len(onsets) < 2:
            return {"error": "not enough onsets"}
        iois = np.clip(np.diff(onsets), self.min_ioi, self.max_ioi)
        symbols = self._quantize(iois)
        if symbols.size == 0:
            return {"error": "could not quantize IOIs"}
        if len(symbols) < self.n_gram:
            return {"ipe_score": 0.0}
        ngrams = [
            tuple(symbols[i:i + self.n_gram])
            for i in range(len(symbols) - self.n_gram + 1)
        ]
        counts = Counter(ngrams)
        total = len(ngrams)
        entropy = -sum(
            (c / total) * np.log2(c / total) for c in counts.values()
        )
        return {"ipe_score": float(entropy)}
