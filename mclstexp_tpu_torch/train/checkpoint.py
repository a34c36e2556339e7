"""Per-fold checkpoints with ``torch.save``.

The layout mirrors the JAX build and the reference:
``<root>/<dataset>/<section>/best_<fold>/``. The port writes one file,
``state.pt``, holding the step, the model ``state_dict`` (reference keys)
and the optimizer state. ``load_checkpoint`` restores the model from it
(what eval and serving need); resuming training with the optimizer state is
queued in ROADMAP.md.
"""

from __future__ import annotations

import os

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


def load_checkpoint(path: str, model: nn.Module) -> int:
    """Load the model ``state_dict`` of ``<path>/state.pt`` into ``model``
    with ``strict=True``, onto the model's device; returns the saved step.
    The optimizer state is not restored."""
    device = next(model.parameters()).device
    saved = torch.load(os.path.join(path, STATE_FILE), map_location=device, weights_only=True)
    model.load_state_dict(saved["model"], strict=True)
    return int(saved["step"])
