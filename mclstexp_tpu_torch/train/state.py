"""Train state and optimizer, port of ``mclstexp_tpu/train/state.py``.

``torch.optim.Adam(lr, weight_decay)`` is the JAX build's ``torch_adam``
chain exactly: coupled L2 (the decay joins the gradient before the Adam
moments), b1 0.9, b2 0.999, eps 1e-8. Embedding gradients stay dense, so
the decay reaches every table row as in the JAX chain.
"""

from __future__ import annotations

import dataclasses

import torch

from mclstexp_tpu_torch.config import ModelConfig, TrainConfig
from mclstexp_tpu_torch.core.layers import init_parameters
from mclstexp_tpu_torch.models.mclstexp import MclSTExp


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer and the count of steps taken. The train step
    updates all three in place."""

    model: MclSTExp
    optimizer: torch.optim.Optimizer
    step: int = 0


def torch_adam(params, lr: float, weight_decay: float) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


def create_train_state(model_cfg: ModelConfig, train_cfg: TrainConfig,
                       device="cuda") -> TrainState:
    """Build the model on ``device``, its parameters drawn from a generator
    seeded with ``train_cfg.seed``, and a fresh optimizer. With
    ``model_cfg.pretrained_path`` the image tower is then replaced by the
    pretrained one of that ``.pt`` (the reference's default start)."""
    device = torch.device(device)
    generator = torch.Generator(device=device).manual_seed(train_cfg.seed)
    model = init_parameters(MclSTExp(model_cfg, device=device), generator)
    if model_cfg.pretrained_path:
        from mclstexp_tpu_torch.models.image.torch_import import load_pretrained_tower

        load_pretrained_tower(model, model_cfg.pretrained_path, model_cfg.encoder_name)
    return TrainState(model, torch_adam(model.parameters(), train_cfg.lr,
                                        train_cfg.weight_decay))
