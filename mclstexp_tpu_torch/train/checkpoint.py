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

``load_torch_state_dict`` reads a reference ``.pt`` (a bare ``state_dict``)
with the reference's key shims: a ``module.`` prefix stripped (DataParallel
saves) and ``well`` renamed ``spot`` (older attribute names).
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch
from torch import nn

from mclstexp_tpu_torch.train.state import TrainState

STATE_FILE = "state.pt"


def fold_checkpoint_dir(root: str, dataset: str, section_name: str, fold: int) -> str:
    """<root>/<dataset>/<section>/best_<fold>."""
    return os.path.join(root, dataset, section_name, f"best_{fold}")


def save_checkpoint(path: str, state: TrainState) -> str:
    """Write ``state`` to ``<path>/state.pt``; returns the file's path."""
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, STATE_FILE)
    tmp = out + ".tmp"
    torch.save({"step": state.step, "model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict()}, tmp)
    os.replace(tmp, out)  # a crash mid-save never leaves a torn checkpoint
    return out


def restore_checkpoint(path: str, device="cpu") -> Dict[str, Any]:
    """Read ``<path>/state.pt`` onto ``device``: {"step", "model",
    "optimizer"}."""
    return torch.load(os.path.join(path, STATE_FILE), map_location=device, weights_only=True)


def apply_checkpoint(state: TrainState, restored: Dict[str, Any]) -> TrainState:
    """Put a restored checkpoint into ``state`` in place (the model with
    ``strict=True``, the Adam moments and step counts, the step); returns
    it."""
    state.model.load_state_dict(restored["model"], strict=True)
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
