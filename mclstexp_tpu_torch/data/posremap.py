"""Dense positional-coordinate remap (the Visium 65536-row table fix): port
of ``mclstexp_tpu/data/posremap.py``.

The reference feeds raw pixel coordinates to 65536-row x/y tables; only the
observed values are ever read, so a load-time bijection {observed value ->
dense row id} keeps the per-coordinate embedding semantics exactly while
the tables shrink to about the observed-value count. x and y remap
independently, value-sorted, so train and eval rebuild the same remap from
the same sections; unseen coordinates raise. The saved npz (``x_values``,
``y_values``, ``vocab``) is the JAX package's format: each package loads
the other's.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from mclstexp_tpu_torch.data.section import Section

REFERENCE_POS_ROWS = 65536  # nn.Embedding rows, reference model.py:204-205


@dataclasses.dataclass(frozen=True)
class PosRemap:
    """Bijection from observed raw coordinate values to dense row ids."""

    x_values: np.ndarray  # sorted distinct observed x coords (int64)
    y_values: np.ndarray  # sorted distinct observed y coords (int64)
    vocab: int  # padded table rows: align_up(max(len(x), len(y)), align)

    @classmethod
    def build(cls, sections: Sequence[Section], align: int = 128) -> "PosRemap":
        """Collect distinct coordinate values over ALL sections.

        Build from the full dataset (not a training subset) so the mapping is
        identical across folds and across train/eval invocations."""
        xs = np.unique(np.concatenate([s.positions[:, 0] for s in sections]))
        ys = np.unique(np.concatenate([s.positions[:, 1] for s in sections]))
        n = max(len(xs), len(ys), 1)
        vocab = ((n + align - 1) // align) * align
        return cls(x_values=xs.astype(np.int64), y_values=ys.astype(np.int64),
                   vocab=vocab)

    def _lookup(self, values: np.ndarray, table: np.ndarray, axis: str) -> np.ndarray:
        idx = np.searchsorted(table, values)
        idx = np.clip(idx, 0, len(table) - 1)
        bad = table[idx] != values
        if bad.any():
            missing = np.unique(np.asarray(values)[bad])[:5]
            raise ValueError(
                f"pos remap: unseen {axis} coordinate(s) {missing.tolist()} — "
                f"the remap was built from a dataset that never observed them "
                f"(rebuild it over all sections, data/posremap.py)"
            )
        return idx

    def apply(self, positions: np.ndarray) -> np.ndarray:
        """(N, 2) raw coords -> (N, 2) dense int32 row ids."""
        ix = self._lookup(positions[:, 0], self.x_values, "x")
        iy = self._lookup(positions[:, 1], self.y_values, "y")
        return np.stack([ix, iy], axis=1).astype(np.int32)

    def apply_sections(self, sections: Sequence[Section]) -> List[Section]:
        return [
            dataclasses.replace(s, positions=self.apply(s.positions))
            for s in sections
        ]

    # --- checkpoint interop -------------------------------------------------
    def _pad(self, rows: np.ndarray) -> np.ndarray:
        pad = np.zeros((self.vocab - rows.shape[0], rows.shape[1]), rows.dtype)
        return np.concatenate([rows, pad], axis=0)

    def slice_x(self, full_table: np.ndarray) -> np.ndarray:
        """(65536, d) reference table -> (vocab, d) compact table (exact:
        padding rows are never indexed)."""
        return self._pad(full_table[self.x_values])

    def slice_y(self, full_table: np.ndarray) -> np.ndarray:
        return self._pad(full_table[self.y_values])

    def scatter_x(self, compact: np.ndarray,
                  full_rows: int = REFERENCE_POS_ROWS) -> np.ndarray:
        """(vocab, d) compact table -> (full_rows, d) reference layout.
        Unobserved rows are zero — unreachable by the dataset the remap was
        built from (mirrors torch_export's prefix zero-padding)."""
        out = np.zeros((full_rows, compact.shape[1]), compact.dtype)
        out[self.x_values] = compact[: len(self.x_values)]
        return out

    def scatter_y(self, compact: np.ndarray,
                  full_rows: int = REFERENCE_POS_ROWS) -> np.ndarray:
        out = np.zeros((full_rows, compact.shape[1]), compact.dtype)
        out[self.y_values] = compact[: len(self.y_values)]
        return out

    # --- persistence ---------------------------------------------------------
    def save(self, path: str) -> None:
        np.savez(path, x_values=self.x_values, y_values=self.y_values,
                 vocab=np.int64(self.vocab))

    @classmethod
    def load(cls, path: str) -> "PosRemap":
        with np.load(path) as z:
            return cls(x_values=z["x_values"].astype(np.int64),
                       y_values=z["y_values"].astype(np.int64),
                       vocab=int(z["vocab"]))
