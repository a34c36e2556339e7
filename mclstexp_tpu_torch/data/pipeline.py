"""Batching: host-side index shuffling, device-side batch gathers.

Port of ``mclstexp_tpu/data/pipeline.py``. Batch semantics are the JAX
build's, for parity:
  * training: a global shuffle over the concatenated training sections,
    permuted by ``SeedSequence([seed, epoch])``;
  * eval: sequential batches over the concatenation, no shuffle;
  * the final partial batch is kept (torch DataLoader drop_last=False).

A training set within the device budget stays on the device
(``DeviceResidentData``, one index tensor sent per step); a larger one is
streamed: ``prefetch_to_device`` copies each host batch to the device from
a background thread ahead of the step. Under a mesh a training batch holds
this rank's rows of the images (``parallel.mesh.batch_rows``) and every row
of the expression and positions, which the spot tower attends over whole.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
from typing import Dict, Iterator, List, Sequence

import numpy as np
import torch

from mclstexp_tpu_torch.data.section import Section
from mclstexp_tpu_torch.parallel.mesh import batch_rows

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


def raw_bytes(data: ConcatSections) -> int:
    """The training set's bytes as the JAX loop sums them against
    ``device_data_budget_bytes``: patches, expression and positions."""
    return data.patches.nbytes + data.expression.nbytes + data.positions.nbytes


class DeviceResidentData:
    """The training set on the device; a batch is one gather per field."""

    def __init__(self, data: ConcatSections, device):
        self.n = len(data)
        self.device = torch.device(device)
        self.patches = torch.from_numpy(np.ascontiguousarray(data.patches)).to(self.device)
        self.expression = torch.from_numpy(data.expression).to(self.device)
        self.positions = torch.from_numpy(data.positions).long().to(self.device)

    def take(self, idx: np.ndarray, image_rows: slice = slice(None)) -> Dict[str, torch.Tensor]:
        """The batch of rows ``idx``; of the images only ``idx[image_rows]``."""
        i = torch.from_numpy(np.asarray(idx, np.int64)).to(self.device)
        return {
            "image_u8": self.patches[i[image_rows]],
            "expression": self.expression[i],
            "position": self.positions[i],
        }


def device_train_batches(device_data: DeviceResidentData, batch_size: int, seed: int,
                         epoch: int, mesh=None) -> Iterator[Dict[str, torch.Tensor]]:
    """``train_batches`` over the device-resident set (same order); under
    ``mesh`` each batch's images are this rank's rows."""
    for idx in epoch_order(device_data.n, batch_size, seed, epoch):
        rows = slice(None) if mesh is None else batch_rows(len(idx), mesh)
        yield device_data.take(idx, rows)


def _to_torch(batch: Batch) -> Dict[str, torch.Tensor]:
    """A host batch as tensors, positions as int64 (``DeviceResidentData``'s
    types)."""
    out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    if "position" in out:
        out["position"] = out["position"].long()
    return out


PREFETCH = 2  # batches the producer may hold ready ahead of the step


def prefetch_to_device(iterator: Iterator[Batch], device,
                       mesh=None) -> Iterator[Dict[str, torch.Tensor]]:
    """The host batches of ``iterator`` on ``device``, copied ahead of the
    consumer (``mclstexp_tpu/data/pipeline.py::prefetch_to_device``).

    A background thread slices each batch (under ``mesh`` the images to this
    rank's rows, as ``device_train_batches`` does), and on a card pins it
    and copies it with ``non_blocking`` copies on a side stream, recording
    an event; the consumer's stream waits on that event before the batch is
    used, and the tensors are marked as used on the consumer's stream, so
    their memory is not reused before the step that reads them is done. At
    most ``PREFETCH`` batches wait. An exception of the producer (reading the
    patch cache, a copy) is raised in the consumer, so it never ends an
    epoch early in silence. Closing the generator stops the thread."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            stream = torch.cuda.Stream(device) if cuda else None
            with torch.cuda.stream(stream) if cuda else contextlib.nullcontext():
                for batch in iterator:
                    if mesh is not None:
                        rows = batch_rows(len(batch["expression"]), mesh)
                        batch = dict(batch, image_u8=batch["image_u8"][rows])
                    host = _to_torch(batch)
                    if cuda:
                        host = {k: v.pin_memory() for k, v in host.items()}
                    on_device = {k: v.to(device, non_blocking=True) for k, v in host.items()}
                    if not put((on_device, stream.record_event() if cuda else None)):
                        return
        except BaseException as e:  # noqa: BLE001 - shipped to the consumer and raised there
            put(e)
        else:
            put(end)

    thread = threading.Thread(target=produce, name="prefetch_to_device", daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            batch, ready = item
            if ready is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(ready)
                for v in batch.values():
                    v.record_stream(consumer)
            yield batch
    finally:
        stop.set()
        thread.join()


def num_train_steps(n: int, batch_size: int) -> int:
    return -(-n // batch_size)


def split_fold(sections: Sequence[Section], fold: int) -> tuple[List[Section], Section]:
    """Leave-one-section-out: (train sections, held-out ``sections[fold]``)."""
    test = sections[fold]
    train = [s for i, s in enumerate(sections) if i != fold]
    return train, test
