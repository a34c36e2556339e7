"""Batching: host-side index shuffling, device-side batch gathers.

Port of ``mclstexp_tpu/data/pipeline.py``. Batch semantics are the JAX
build's, for parity:
  * training: a global shuffle over the concatenated training sections,
    permuted by ``SeedSequence([seed, epoch])``;
  * eval: sequential batches over the concatenation, no shuffle;
  * the final partial batch is kept (torch DataLoader drop_last=False).

The port keeps the whole training set on the device (``DeviceResidentData``)
and sends one index tensor per step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Sequence

import numpy as np
import torch

from mclstexp_tpu_torch.data.section import Section

Batch = Dict[str, np.ndarray]


@dataclasses.dataclass
class ConcatSections:
    """Concatenated per-field views over a list of sections."""

    patches: np.ndarray  # (N, P, P, 3) uint8
    expression: np.ndarray  # (N, G) float32
    positions: np.ndarray  # (N, 2) int32
    centers: np.ndarray  # (N, 2) int32
    section_sizes: List[int]
    section_names: List[str]

    @classmethod
    def from_sections(cls, sections: Sequence[Section]) -> "ConcatSections":
        if any(s.patches is None for s in sections):
            raise ValueError("sections need patches")
        return cls(
            patches=np.concatenate([np.asarray(s.patches) for s in sections], axis=0),
            expression=np.concatenate([s.expression for s in sections], axis=0),
            positions=np.concatenate([s.positions for s in sections], axis=0),
            centers=np.concatenate([s.centers for s in sections], axis=0),
            section_sizes=[s.num_spots for s in sections],
            section_names=[s.name for s in sections],
        )

    def __len__(self) -> int:
        return len(self.expression)

    def take(self, idx: np.ndarray) -> Batch:
        return {
            "image_u8": self.patches[idx],
            "expression": self.expression[idx],
            "position": self.positions[idx],
        }


def epoch_order(n: int, batch_size: int, seed: int, epoch: int) -> Iterator[np.ndarray]:
    """The index batches of one shuffled epoch, the partial one last."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
    order = rng.permutation(n)
    for start in range(0, n, batch_size):
        yield order[start : start + batch_size]


def train_batches(data: ConcatSections, batch_size: int, seed: int,
                  epoch: int) -> Iterator[Batch]:
    """One epoch of shuffled host batches (uint8 patches)."""
    for idx in epoch_order(len(data), batch_size, seed, epoch):
        yield data.take(idx)


def eval_batches(data: ConcatSections, batch_size: int) -> Iterator[Batch]:
    """Sequential batches over the concatenation (no shuffle, remainder kept)."""
    n = len(data)
    for start in range(0, n, batch_size):
        yield data.take(np.arange(start, min(start + batch_size, n)))


class DeviceResidentData:
    """The training set on the device; a batch is one gather per field."""

    def __init__(self, data: ConcatSections, device):
        self.n = len(data)
        self.device = torch.device(device)
        self.patches = torch.from_numpy(np.ascontiguousarray(data.patches)).to(self.device)
        self.expression = torch.from_numpy(data.expression).to(self.device)
        self.positions = torch.from_numpy(data.positions).long().to(self.device)

    def take(self, idx: np.ndarray) -> Dict[str, torch.Tensor]:
        i = torch.from_numpy(np.asarray(idx, np.int64)).to(self.device)
        return {
            "image_u8": self.patches[i],
            "expression": self.expression[i],
            "position": self.positions[i],
        }


def device_train_batches(device_data: DeviceResidentData, batch_size: int, seed: int,
                         epoch: int) -> Iterator[Dict[str, torch.Tensor]]:
    """``train_batches`` over the device-resident set (same order)."""
    for idx in epoch_order(device_data.n, batch_size, seed, epoch):
        yield device_data.take(idx)


def num_train_steps(n: int, batch_size: int) -> int:
    return -(-n // batch_size)


def split_fold(sections: Sequence[Section], fold: int) -> tuple[List[Section], Section]:
    """Leave-one-section-out: (train sections, held-out ``sections[fold]``)."""
    test = sections[fold]
    train = [s for i, s in enumerate(sections) if i != fold]
    return train, test
