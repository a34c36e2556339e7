"""Post-hoc analysis: per-gene ranking, spatial plots, domain clustering.

Port of ``mclstexp_tpu/infer/analysis.py`` (the reference's
``tutorial.ipynb``): rank genes by the mean -log10(p) of their
prediction-vs-truth correlation across sections, plot a gene's predicted
and measured spatial maps, and cluster predicted expression against
pathologist annotations (ARI/NMI).

The ranking is a pandas-free table: a dict of five equal-length columns
(``gene``, ``mean_pcc``, ``mean_neglog10_p``, ``best_section``,
``best_pcc``), rows in the order of the JAX package's
``DataFrame.sort_values("mean_neglog10_p", ascending=False)``. That order is
pandas' ``nargsort``, reproduced here: NaN rows last, the others by numpy's
default (quicksort) argsort of the reversed column, reversed back. Genes
whose p-value underflows all get -log10(1e-300) = 300 and tie; that rule
places them. The plots import matplotlib inside, as the JAX package does;
it need not be installed for the rest.
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional, Sequence

import numpy as np

from mclstexp_tpu_torch.infer.metrics import cluster_predictions, pearson_per_gene

RANKING_COLUMNS = ("gene", "mean_pcc", "mean_neglog10_p", "best_section", "best_pcc")


def _descending_order(values: np.ndarray) -> np.ndarray:
    """pandas' ``nargsort(values, ascending=False, na_position="last")``."""
    idx = np.arange(len(values))
    mask = np.isnan(values)
    non_nans, non_nan_idx = values[~mask][::-1], idx[~mask][::-1]
    order = non_nan_idx[non_nans.argsort(kind="quicksort")][::-1]
    return np.concatenate([order, np.nonzero(mask)[0]])


def gene_ranking(
    preds: Sequence[np.ndarray],  # per section (N_i, G)
    truths: Sequence[np.ndarray],
    gene_names: Sequence[str],
    section_names: Optional[Sequence[str]] = None,
) -> Dict[str, object]:
    """Per-gene prediction quality across sections (tutorial cell 2): mean
    PCC, mean -log10(p), the best section and its PCC, sorted by mean
    -log10(p) descending. Returns the columns of ``RANKING_COLUMNS``:
    ``gene`` and ``best_section`` lists of str, the others float64 arrays."""
    section_names = section_names or [f"S{i}" for i in range(len(preds))]
    rs, logps = [], []
    for pred, true in zip(preds, truths):
        r, p = pearson_per_gene(pred, true)
        rs.append(r)
        with np.errstate(divide="ignore"):
            logps.append(-np.log10(np.clip(p, 1e-300, None)))
    rs = np.stack(rs)  # (S, G)
    logps = np.stack(logps)

    # an all-NaN gene's means are NaN, as in the JAX package
    with np.errstate(invalid="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # "Mean of empty slice"
        mean_r = np.nanmean(rs, axis=0)
        mean_logp = np.nanmean(logps, axis=0)
    best_idx = np.nanargmax(np.where(np.isnan(rs), -np.inf, rs), axis=0)
    order = _descending_order(mean_logp)
    genes = list(gene_names)
    return {
        "gene": [genes[i] for i in order],
        "mean_pcc": mean_r[order],
        "mean_neglog10_p": mean_logp[order],
        "best_section": [section_names[best_idx[i]] for i in order],
        "best_pcc": rs[best_idx, np.arange(rs.shape[1])][order],
    }


def format_ranking(table: Dict[str, object], rows: int = 5) -> str:
    """The first ``rows`` rows of a ``gene_ranking`` table as aligned text,
    one line per gene under a header line."""
    cells = [[str(i)] + [f"{table[c][i]:.6f}" if isinstance(table[c][i], float) else
                         str(table[c][i]) for c in RANKING_COLUMNS]
             for i in range(min(rows, len(table["gene"])))]
    header = [""] + list(RANKING_COLUMNS)
    widths = [max(len(r[j]) for r in [header] + cells) for j in range(len(header))]
    return "\n".join(" ".join(v.rjust(w) for v, w in zip(r, widths))
                     for r in [header] + cells)


def spatial_plot(
    centers: np.ndarray,  # (N, 2) pixel (x, y)
    values: np.ndarray,  # (N,) per-spot values (e.g. one gene's expression)
    title: str = "",
    ax=None,
    cmap: str = "viridis",
    spot_size: float = 12.0,
):
    """Scatter a per-spot quantity at its spatial coordinates (the tutorial's
    spatial expression plots). Returns the matplotlib axis."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(4, 4))
    sc = ax.scatter(centers[:, 0], centers[:, 1], c=values, s=spot_size, cmap=cmap)
    ax.invert_yaxis()
    ax.set_aspect("equal")
    ax.set_title(title)
    ax.axis("off")
    plt.colorbar(sc, ax=ax, shrink=0.7)
    return ax


def compare_gene_plot(
    centers: np.ndarray,
    pred: np.ndarray,  # (N, G)
    true: np.ndarray,
    gene_names: Sequence[str],
    gene: str,
    out_path: Optional[str] = None,
):
    """Side-by-side predicted vs measured spatial maps for one gene; written
    to ``out_path`` when given. Returns the figure."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    g = list(gene_names).index(gene)
    r, _ = pearson_per_gene(pred[:, g:g + 1], true[:, g:g + 1])
    fig, axes = plt.subplots(1, 2, figsize=(9, 4))
    spatial_plot(centers, pred[:, g], f"{gene} predicted (r={r[0]:.3f})", axes[0])
    spatial_plot(centers, true[:, g], f"{gene} measured", axes[1])
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=120)
    return fig


def domain_clustering(pred: np.ndarray, labels: Sequence[str],
                      device="cuda") -> Dict[str, float]:
    """Predicted-expression domain clustering vs pathologist labels
    (tutorial cell 3; the reference's ``utils.py:67-79``), PCA and k-means
    on ``device``."""
    return cluster_predictions(pred, labels, device=device)

