"""Expression normalization (NumPy): the port's own copy of the helpers of
``mclstexp_tpu/data/normalize.py`` that the ported slices read: the
per-spot train normalization and the per-gene eval normalization.

The reference normalizes every section with scprep's library-size
normalization (rescale 10,000) then log10(x + 1).
"""

from __future__ import annotations

import numpy as np


def library_size_normalize(counts: np.ndarray, rescale: float = 10000.0) -> np.ndarray:
    """L1-normalize rows (spots) and rescale; zero-count spots stay zero."""
    counts = np.asarray(counts, dtype=np.float64)
    lib = counts.sum(axis=1, keepdims=True)
    safe_lib = np.where(lib == 0, 1.0, lib)
    return counts / safe_lib * float(rescale)


def log_transform(x: np.ndarray, pseudocount: float = 1.0, base: float = 10.0) -> np.ndarray:
    """scprep.transform.log equivalent: log_base(x + pseudocount)."""
    return (np.log(np.asarray(x, dtype=np.float64) + pseudocount) / np.log(base)).astype(
        np.float32
    )


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
