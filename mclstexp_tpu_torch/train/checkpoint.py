"""Per-fold checkpoints with ``torch.save``.

The layout mirrors the JAX build and the reference:
``<root>/<dataset>/<section>/best_<fold>/``. The port writes one file,
``state.pt``, holding the step, the model ``state_dict`` (reference keys)
and the optimizer state. It keeps no compute dtype, as the JAX build's
checkpoints keep none: the parameters are fp32 either way, and a reader
builds the model in the dtype it asks for (the command line's ``--dtype``).
``load_checkpoint`` restores the model from it
(what eval and serving need); ``restore_checkpoint`` + ``apply_checkpoint``
restore the whole train state (what resuming a fold needs), as the JAX
build's functions of the same names do.

``save_checkpoint_on_lead`` is the write of a data-parallel run: rank 0
writes, and every rank waits at a barrier until the file is whole. A
tensor-parallel state's shards are gathered whole first, on every rank.

``load_torch_state_dict`` reads a reference ``.pt`` (a bare ``state_dict``)
with the reference's key shims: a ``module.`` prefix stripped (DataParallel
saves) and ``well`` renamed ``spot`` (older attribute names).
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from mclstexp_tpu_torch.parallel import distributed
from mclstexp_tpu_torch.train.state import TrainState

STATE_FILE = "state.pt"


def fold_checkpoint_dir(root: str, dataset: str, section_name: str, fold: int) -> str:
    """<root>/<dataset>/<section>/best_<fold>."""
    return os.path.join(root, dataset, section_name, f"best_{fold}")


def _whole(obj):
    """``obj`` (a state dict, nested dicts and lists) with every DTensor
    gathered whole: a collective over its mesh, which every rank joins."""
    if isinstance(obj, DTensor):
        return obj.full_tensor()
    if isinstance(obj, dict):
        return {k: _whole(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_whole(v) for v in obj)
    return obj


def checkpoint_payload(state: TrainState) -> Dict[str, Any]:
    """What ``state.pt`` holds: the step, the model ``state_dict`` and the
    optimizer's, tensor-parallel parameters and their Adam moments whole
    (``parallel.tp``), so that one process loads it."""
    return {"step": state.step, "model": _whole(state.model.state_dict()),
            "optimizer": _whole(state.optimizer.state_dict())}


def write_checkpoint(path: str, payload: Dict[str, Any]) -> str:
    """Write ``payload`` to ``<path>/state.pt``; returns the file's path."""
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, STATE_FILE)
    tmp = out + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, out)  # a crash mid-save never leaves a torn checkpoint
    return out


def save_checkpoint(path: str, state: TrainState) -> str:
    """Write ``state`` to ``<path>/state.pt``; returns the file's path."""
    return write_checkpoint(path, checkpoint_payload(state))


def save_checkpoint_on_lead(path: str, state: TrainState) -> None:
    """Every rank gathers the payload (a tensor-parallel model's shards
    whole), rank 0 of the process group (the only process without one)
    writes it, then a barrier over the group: every rank's state is the
    same, one copy is written, and no rank goes on to read it early."""
    payload = checkpoint_payload(state)
    if distributed.rank() == 0:
        write_checkpoint(path, payload)
    distributed.sync_hosts("checkpoint")


def restore_checkpoint(path: str, device="cpu") -> Dict[str, Any]:
    """Read ``<path>/state.pt`` onto ``device``: {"step", "model",
    "optimizer"}."""
    return torch.load(os.path.join(path, STATE_FILE), map_location=device, weights_only=True)


def apply_checkpoint(state: TrainState, restored: Dict[str, Any]) -> TrainState:
    """Put a restored checkpoint into ``state`` in place (the model with
    ``strict=True``, the Adam moments and step counts, the step); returns
    it. An optimizer state that indexes other parameters than the model
    trains is refused."""
    state.model.load_state_dict(restored["model"], strict=True)
    saved = [len(g["params"]) for g in restored["optimizer"]["param_groups"]]
    trained = [len(g["params"]) for g in state.optimizer.param_groups]
    if saved != trained:
        raise ValueError(
            f"the checkpoint's optimizer state indexes {saved} parameters, the model trains "
            f"{trained}: a Hist2ST fold checkpoint written while its LSTM's bias_hh_l0 and "
            "bias_hh_l1 were frozen parameters (they are fixed buffers now) lists those two "
            "as well; retrain the fold, or drop their two places from the saved param group")
    state.optimizer.load_state_dict(restored["optimizer"])
    state.step = int(restored["step"])
    return state


def load_checkpoint(path: str, model: nn.Module) -> int:
    """Load the model ``state_dict`` of ``<path>/state.pt`` into ``model``
    with ``strict=True``, onto the model's device; returns the saved step.
    The optimizer state is not restored."""
    saved = restore_checkpoint(path, next(model.parameters()).device)
    model.load_state_dict(saved["model"], strict=True)
    return int(saved["step"])


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Read a reference ``state_dict`` ``.pt`` onto the CPU and apply the
    reference's key shims."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {key.replace("module.", "").replace("well", "spot"): tensor
            for key, tensor in sd.items()}
