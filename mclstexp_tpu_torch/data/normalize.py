"""Expression normalization (NumPy): the port's own copy of
``mclstexp_tpu/data/normalize.py``: the per-spot train normalization, the
per-gene eval normalization and the scanpy-style helpers of the HVG panel.

The reference normalizes every section with scprep's library-size
normalization (rescale 10,000) then log10(x + 1).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np


def library_size_normalize(
    counts: np.ndarray, rescale: Union[float, str, None] = 10000.0
) -> np.ndarray:
    """L1-normalize rows (spots) and rescale.

    rescale: a number, 'median'/'mean' (of the library sizes), or None (L1 only).
    Zero-count spots are left at zero rather than producing NaNs.
    """
    counts = np.asarray(counts, dtype=np.float64)
    lib = counts.sum(axis=1, keepdims=True)
    safe_lib = np.where(lib == 0, 1.0, lib)
    normed = counts / safe_lib
    if rescale is None:
        factor = 1.0
    elif isinstance(rescale, str):
        sizes = lib[lib > 0]
        factor = float(np.median(sizes)) if rescale == "median" else float(np.mean(sizes))
    else:
        factor = float(rescale)
    return normed * factor


def log_transform(x: np.ndarray, pseudocount: float = 1.0, base: float = 10.0) -> np.ndarray:
    """scprep.transform.log equivalent: log_base(x + pseudocount)."""
    return (np.log(np.asarray(x, dtype=np.float64) + pseudocount) / np.log(base)).astype(
        np.float32
    )


def normalize_total(counts: np.ndarray, target_sum: Optional[float] = None) -> np.ndarray:
    """scanpy ``sc.pp.normalize_total``: scale each spot to ``target_sum``,
    by default the median library size."""
    counts = np.asarray(counts, dtype=np.float64)
    lib = counts.sum(axis=1, keepdims=True)
    if target_sum is None:
        target_sum = float(np.median(lib[lib > 0]))
    safe_lib = np.where(lib == 0, 1.0, lib)
    return counts / safe_lib * target_sum


def log1p(x: np.ndarray) -> np.ndarray:
    """scanpy ``sc.pp.log1p`` (natural log)."""
    return np.log1p(np.asarray(x, dtype=np.float64))


def logcpm_panel(counts_panel: np.ndarray) -> np.ndarray:
    """log10(1 + 1e4 * x / libsize) of a section already subset to the gene
    panel. Returns float32 (N, G)."""
    return log_transform(library_size_normalize(counts_panel))


def pergene_logcpm(counts_panel: np.ndarray) -> np.ndarray:
    """Per-GENE library-size normalization: the reference's eval-phase
    matrices (retrieval keys and ground truth).

    The reference's hvg scripts transpose to genes x spots before the row
    normalizer, so every gene row is scaled to a 10,000 "library", unlike
    the per-spot normalization of training. Returns float32 (N, G).
    """
    return log_transform(library_size_normalize(counts_panel.T)).T
