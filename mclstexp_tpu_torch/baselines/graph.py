"""Spot graph of the GNN baselines: the k-NN adjacency over array coords.

Port of ``knn_adjacency`` of ``mclstexp_tpu/baselines/graph.py`` (the
reference's ``calcADJ``, ``baselines/His2ST/graph_construction.py:4-30``),
NumPy in both packages: each spot links to its k nearest others by the
metric, pruned by "grid" (distance <= 2, the grid's own neighbours), "std"
(within mean + std of the k distances) or "none". ``np.argsort`` (its
default quicksort) breaks distance ties as the JAX package's does, so the
same coordinates give the same matrix.
"""

from __future__ import annotations

import numpy as np


def knn_adjacency(
    coords: np.ndarray,
    k: int = 4,
    metric: str = "euclidean",
    prune: str = "grid",
) -> np.ndarray:
    """Dense (N, N) float32 adjacency; coords (N, 2) array coordinates."""
    coords = np.asarray(coords, dtype=np.float64)
    n = len(coords)
    if k == 0:
        k = n - 1
    k = min(k, n - 1)

    diff = coords[:, None, :] - coords[None, :, :]
    if metric == "euclidean":
        dist = np.sqrt((diff**2).sum(-1))
    elif metric == "cityblock":
        dist = np.abs(diff).sum(-1)
    else:
        raise ValueError(f"unknown metric {metric!r}")

    order = np.argsort(dist, axis=1)  # column 0 is self
    neigh = order[:, 1 : k + 1]  # (N, k)
    ndist = np.take_along_axis(dist, neigh, axis=1)

    if prune in ("na", "none", None):
        keep = np.ones_like(ndist, dtype=bool)
    elif prune == "grid":
        keep = ndist <= 2.0
    elif prune == "std":
        bound = ndist.mean(axis=1, keepdims=True) + ndist.std(axis=1, keepdims=True)
        keep = ndist <= bound
    else:
        raise ValueError(f"unknown prune {prune!r}")

    adj = np.zeros((n, n), dtype=np.float32)
    rows = np.repeat(np.arange(n), k)
    adj[rows[keep.ravel()], neigh.ravel()[keep.ravel()]] = 1.0
    return adj
