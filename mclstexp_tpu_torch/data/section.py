"""The uniform section record every dataset reader produces.

Port of ``mclstexp_tpu/data/section.py``: one record per tissue section,
held as NumPy arrays on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Section:
    name: str
    expression: np.ndarray  # (N, G) float32 log-CPM over the HVG panel
    positions: np.ndarray  # (N, 2) int32: what the (x, y) tables index
    centers: np.ndarray  # (N, 2) int32 pixel (x, y) patch centers
    patches: Optional[np.ndarray] = None  # (N, P, P, 3) uint8, pre-cut
    labels: Optional[np.ndarray] = None  # pathologist annotations (strings)
    counts: Optional[np.ndarray] = None  # (N, G) raw counts over the panel

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
