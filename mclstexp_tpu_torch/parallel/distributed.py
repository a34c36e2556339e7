"""Multi-process initialization: one process per card.

Port of ``mclstexp_tpu/parallel/distributed.py``. JAX runs one process per
host and sees every local device from it; torch runs one process per card
(``torchrun --nproc-per-node N``), each with its own rank, joined by a
``torch.distributed`` process group: NCCL between cards, gloo on the CPU.

* ``maybe_initialize_distributed``: explicit ``--coordinator host:port``,
  ``--num-processes`` and ``--process-id`` rendezvous over ``tcp://``;
  ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``)
  over ``env://``; neither, no group (a no-op). On a card the process first
  takes its own, ``cuda:{LOCAL_RANK}`` (``torch.cuda.set_device``), before
  the NCCL group exists.
* ``process_shard``: this rank's contiguous share of a work list (the
  sections each rank pre-cuts into the patch cache).
* ``sync_hosts``: a barrier over the group (after the pre-cut and rank 0's
  writes); under NCCL it names this process's card, since a barrier
  without ``device_ids`` may guess another.
* ``local_device``: ``cuda`` -> ``cuda:{LOCAL_RANK}``.

``sync_hosts`` and ``process_shard`` work over whatever group is
initialized, the one-rank group included (``parallel.mesh.make_mesh``
makes one when none is), so a single process runs the same collectives as
many.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

_ENV_KEYS = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def local_rank() -> int:
    """This process's card index on its host (``torchrun``'s ``LOCAL_RANK``;
    0 without it)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def local_device(device="cuda") -> str:
    """``device`` with the card index of this process: a bare ``cuda`` becomes
    ``cuda:{LOCAL_RANK}``; ``cpu`` and an explicit ``cuda:i`` stay."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return f"cuda:{local_rank()}"
    return str(device)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """The process group's size; 1 without a group."""
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def maybe_initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
) -> bool:
    """Join the process group when the command runs as several processes;
    no-op otherwise. Returns True when more than one process takes part.

    Explicit arguments take ``tcp://coordinator_address`` with
    ``num_processes`` ranks (and this one ``process_id``); where one of the
    two counts is missing, ``torchrun``'s ``WORLD_SIZE`` / ``RANK`` fill it.
    Without arguments, ``torchrun``'s environment (``env://``). The backend
    is NCCL for a CUDA ``device`` and gloo for the CPU. Safe to call at every
    command's entry, and again once joined."""
    if is_initialized():
        return world_size() > 1
    explicit = coordinator_address is not None or num_processes is not None
    if not explicit and not all(os.environ.get(k) for k in _ENV_KEYS):
        return False
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(local_rank())
    backend = "nccl" if cuda else "gloo"
    if explicit:
        if num_processes is None:
            num_processes = int(os.environ.get("WORLD_SIZE", "0"))
        if process_id is None:
            process_id = int(os.environ.get("RANK", "-1"))
        if not coordinator_address or num_processes < 1 or \
                not 0 <= process_id < num_processes:
            raise ValueError(
                f"multi-process init needs --coordinator host:port, --num-processes and "
                f"--process-id (got {coordinator_address!r}, {num_processes}, {process_id})")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    else:
        dist.init_process_group(backend, init_method="env://")
    return world_size() > 1


def process_shard(n_items: int) -> slice:
    """This rank's contiguous shard of a global work list of ``n_items``
    (the split the reference gets from ``DistributedSampler``)."""
    pc, pi = world_size(), rank()
    per = (n_items + pc - 1) // pc
    return slice(pi * per, min((pi + 1) * per, n_items))


def sync_hosts(tag: str = "sync") -> None:
    """Barrier across the group's processes (no-op without a group). Used
    after the patch-cache pre-cut and after rank 0's checkpoint and
    ``pos_remap.npz`` writes, so that no rank reads a half-written file.
    ``tag`` names the barrier in a failure."""
    if not is_initialized():
        return
    try:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()
    except RuntimeError as e:
        raise RuntimeError(f"barrier {tag!r} failed on rank {rank()}: {e}") from e


def shutdown() -> None:
    """Destroy the process group if one is initialized."""
    if is_initialized():
        dist.destroy_process_group()
