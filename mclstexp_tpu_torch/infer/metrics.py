"""Evaluation metrics: gene-wise PCC (+p), HEG selection, MSE/MAE.

Port of ``mclstexp_tpu/infer/metrics.py``. Semantics are the reference's:
  * per-gene Pearson r and two-sided p across spots, in float64 on the host
    (scipy for p); constant columns give NaN r, which the HVG mean drops;
  * HEG: the 50 highest-mean genes of the *ground truth*, with the
    reference's ``np.argsort(mean)[::-1][:50]`` tie-breaking;
  * MSE/MAE: uniform averages over all entries.
``expression_metrics_device`` computes the same bundle in fp32 torch on the
tensors' device, for the LOO fold loop, with one 4-scalar readback.
``cluster_predictions`` is the domain clustering of the tutorial, on the
port's own PCA, k-means and scores (``infer/cluster.py``).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from mclstexp_tpu_torch.infer import cluster


def pearson_per_gene(pred: np.ndarray, true: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized per-column Pearson r and two-sided p ((N, G) arrays)."""
    from scipy import stats

    pred = np.asarray(pred, dtype=np.float64)
    true = np.asarray(true, dtype=np.float64)
    n = pred.shape[0]
    pc = pred - pred.mean(axis=0)
    tc = true - true.mean(axis=0)
    denom = np.sqrt((pc**2).sum(0) * (tc**2).sum(0))
    with np.errstate(invalid="ignore", divide="ignore"):
        r = (pc * tc).sum(0) / denom
    r = np.where(denom == 0, np.nan, r)
    r = np.clip(r, -1.0, 1.0)
    with np.errstate(invalid="ignore", divide="ignore"):
        t = r * np.sqrt((n - 2) / (1.0 - r**2))
    p = 2.0 * stats.t.sf(np.abs(t), df=n - 2)
    p = np.where(np.isnan(r), np.nan, p)
    p = np.where(np.abs(r) >= 1.0, 0.0, p)
    return r, p


def heg_indices(true: np.ndarray, k: int = 50) -> np.ndarray:
    """Top-k highest-mean genes, reference tie-breaking (argsort + [::-1])."""
    gene_mean = np.mean(np.asarray(true), axis=0)
    return np.argsort(gene_mean)[::-1][:k]


def mse(pred: np.ndarray, true: np.ndarray) -> float:
    return float(np.mean((np.asarray(true) - np.asarray(pred)) ** 2))


def mae(pred: np.ndarray, true: np.ndarray) -> float:
    return float(np.mean(np.abs(np.asarray(true) - np.asarray(pred))))


def expression_metrics(pred: np.ndarray, true: np.ndarray, heg_k: int = 50) -> Dict[str, float]:
    """The per-fold metric bundle of the reference's eval scripts."""
    hvg_pcc, _ = pearson_per_gene(pred, true)
    heg_idx = heg_indices(true, heg_k)
    heg_pcc, _ = pearson_per_gene(pred[:, heg_idx], true[:, heg_idx])
    hvg_valid = hvg_pcc[~np.isnan(hvg_pcc)]
    return {
        "hvg_pcc": float(np.mean(hvg_valid)),
        "heg_pcc": float(np.mean(heg_pcc)),  # the reference takes the raw mean
        "mse": mse(pred, true),
        "mae": mae(pred, true),
    }


def _pcc(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    pc = p - p.mean(dim=0)
    tc = t - t.mean(dim=0)
    denom2 = (pc * pc).sum(dim=0) * (tc * tc).sum(dim=0)
    zero = denom2 == 0
    r = (pc * tc).sum(dim=0) / torch.sqrt(torch.where(zero, torch.ones_like(denom2), denom2))
    return torch.where(zero, torch.full_like(r, float("nan")), r.clamp(-1.0, 1.0))


def expression_metrics_device(pred: torch.Tensor, true: torch.Tensor,
                              heg_idx: np.ndarray) -> Dict[str, float]:
    """``expression_metrics`` in fp32 on the tensors' device: one 4-scalar
    readback instead of moving the (N, G) prediction to the host.

    Pinned to the fp64 host bundle at rtol 3e-5, NaN-drop and NaN-propagation
    policies included. ``heg_idx`` must come from ``heg_indices`` on the host
    ground truth, so the reference's argsort tie-breaking holds exactly.
    """
    pred = pred.float()
    true = true.float()
    r = _pcc(pred, true)
    valid = ~torch.isnan(r)
    n_valid = valid.sum()
    hvg = torch.where(
        n_valid == 0,
        torch.full_like(r[0], float("nan")),  # the host's mean of an empty set
        torch.where(valid, r, torch.zeros_like(r)).sum() / n_valid.clamp_min(1),
    )
    idx = torch.as_tensor(np.ascontiguousarray(heg_idx), dtype=torch.int64, device=pred.device)
    heg = _pcc(pred[:, idx], true[:, idx]).mean()  # raw mean: NaN propagates
    err = true - pred
    vals = torch.stack([hvg, heg, (err * err).mean(), err.abs().mean()]).cpu().tolist()
    return dict(zip(("hvg_pcc", "heg_pcc", "mse", "mae"), vals))


def cluster_predictions(pred: np.ndarray, labels: Sequence[str], n_components: int = 9,
                        random_state: int = 0, device="cuda") -> Dict[str, float]:
    """KMeans domain clustering of predicted expression against pathologist
    labels: spots labelled "undetermined" dropped, PCA to ``min(9, N - 1,
    G)`` components, k-means++ KMeans with one cluster per label, then ARI
    and NMI rounded to 3 places (the reference's ``utils.py:67-79``). PCA
    and the Lloyd loop run on ``device``; the PCA is scikit-learn's default
    solver for the data's shape (``infer/cluster.py``), randomized at
    her2st's 785 genes."""
    labels = np.asarray(labels)
    keep = labels != "undetermined"
    x = np.asarray(pred)[keep]
    kept = labels[keep]
    n_clusters = len(set(kept.tolist()))
    comps = min(n_components, x.shape[0] - 1, x.shape[1])
    x_pca = cluster.pca(x, comps, random_state=random_state, device=device)
    assign, _ = cluster.kmeans(x_pca, n_clusters, random_state=random_state, device=device)
    assign = assign.astype(str)
    return {
        "ari": float(round(cluster.adjusted_rand_score(assign, kept), 3)),
        "nmi": float(round(cluster.normalized_mutual_info_score(kept, assign), 3)),
        "n_clusters": n_clusters,
    }
