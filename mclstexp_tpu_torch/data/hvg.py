"""Highly-variable-gene selection (seurat flavor), NumPy only: port of
``mclstexp_tpu/data/hvg.py``.

Replicates scanpy ``sc.pp.highly_variable_genes(adata, n_top_genes=N)``
(flavor='seurat') as the reference HVG pipeline runs it per section, on
log1p-normalized data:

  1. un-log (expm1), per-gene mean and dispersion = var / mean (ddof=1);
     then mean <- log1p(mean), dispersion <- log(dispersion);
  2. 20 equal-width bins of the log1p mean; z-score the log dispersion
     within each bin (a bin of one gene has z = disp / bin mean, scanpy's
     quirk);
  3. the top-N genes by normalized dispersion, ties broken by a stable sort.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def seurat_dispersion(log_data: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-gene (mean, normalized dispersion) on log1p data, seurat flavor."""
    x = np.expm1(np.asarray(log_data, dtype=np.float64))
    mean = x.mean(axis=0)
    var = x.var(axis=0, ddof=1)
    mean_safe = np.where(mean == 0, 1e-12, mean)
    dispersion = var / mean_safe
    disp_log = np.log(np.where(dispersion == 0, np.nan, dispersion))
    mean_log = np.log1p(mean)

    n_bins = 20
    # pd.cut semantics: equal-width bins over [min, max] of the log1p means.
    lo, hi = mean_log.min(), mean_log.max()
    width = (hi - lo) or 1.0
    bin_idx = np.clip(((mean_log - lo) / width * n_bins).astype(int), 0, n_bins - 1)

    disp_norm = np.zeros_like(disp_log)
    for b in range(n_bins):
        mask = bin_idx == b
        if not mask.any():
            continue
        vals = disp_log[mask]
        mu = np.nanmean(vals)
        sd = np.nanstd(vals, ddof=1) if mask.sum() > 1 else np.nan
        if not np.isfinite(sd) or sd == 0:
            # single-gene (or degenerate) bin: scanpy sets std := bin mean,
            # mean := 0, so z = disp / bin_mean.
            denom = mu if (np.isfinite(mu) and mu != 0) else 1.0
            disp_norm[mask] = vals / denom
        else:
            disp_norm[mask] = (vals - mu) / sd
    disp_norm = np.nan_to_num(disp_norm, nan=-np.inf)
    return mean, disp_norm


def highly_variable_genes(log_data: np.ndarray, n_top_genes: int = 1000) -> np.ndarray:
    """Boolean mask of the top-N genes by normalized dispersion."""
    _, disp_norm = seurat_dispersion(log_data)
    return hvg_mask_from_dispersion(disp_norm, n_top_genes)


def hvg_mask_from_dispersion(disp_norm: np.ndarray, n_top_genes: int) -> np.ndarray:
    """Top-N mask from a precomputed normalized dispersion."""
    n_top_genes = min(n_top_genes, disp_norm.shape[0])
    cutoff = np.sort(disp_norm)[::-1][n_top_genes - 1]
    mask = disp_norm >= cutoff
    if mask.sum() > n_top_genes:  # ties at the cutoff: keep the first by a stable sort
        order = np.argsort(-disp_norm, kind="stable")
        mask = np.zeros_like(mask)
        mask[order[:n_top_genes]] = True
    return mask


def hvg_union_intersection(masks: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Union and intersection of per-section HVG masks."""
    masks = np.asarray(masks, dtype=bool)
    return masks.any(axis=0), masks.all(axis=0)
