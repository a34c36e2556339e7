"""The uniform section record every dataset reader produces.

Port of ``mclstexp_tpu/data/section.py``: one record per tissue section,
held as NumPy arrays on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from mclstexp_tpu_torch.data.normalize import pergene_logcpm


@dataclasses.dataclass
class Section:
    name: str
    expression: np.ndarray  # (N, G) float32 log-CPM over the HVG panel
    positions: np.ndarray  # (N, 2) int32: what the (x, y) tables index
    centers: np.ndarray  # (N, 2) int32 pixel (x, y) patch centers
    patches: Optional[np.ndarray] = None  # (N, P, P, 3) uint8, pre-cut
    labels: Optional[np.ndarray] = None  # pathologist annotations (strings)
    counts: Optional[np.ndarray] = None  # (N, G) raw counts over the panel

    @property
    def eval_expression(self) -> np.ndarray:
        """Expression in the eval protocol's normalization: per gene
        (``normalize.pergene_logcpm``) where raw counts exist, else
        ``expression`` unchanged (readers that load per-gene matrices
        directly carry no counts). Computed once per section."""
        if self.counts is None:
            return self.expression
        if getattr(self, "_eval_expression", None) is None:
            self._eval_expression = pergene_logcpm(self.counts)
        return self._eval_expression

    @property
    def size_factors(self) -> Optional[np.ndarray]:
        """Library size over its median (the NB/ZINB heads' size factors),
        None without counts."""
        if self.counts is None:
            return None
        lib = self.counts.sum(axis=1)
        med = np.median(lib[lib > 0]) if (lib > 0).any() else 1.0
        return (lib / med).astype(np.float32)

    def __post_init__(self):
        n = len(self.expression)
        if len(self.positions) != n or len(self.centers) != n:
            raise ValueError(f"section {self.name}: inconsistent lengths")

    @property
    def num_spots(self) -> int:
        return len(self.expression)

    @property
    def num_genes(self) -> int:
        return self.expression.shape[1]
