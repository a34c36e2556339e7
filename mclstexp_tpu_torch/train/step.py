"""The train step: augment -> towers -> InfoNCE -> Adam.

Port of ``mclstexp_tpu/train/step.py`` for augment modes "st" (jitter,
flip, rotate; the ST datasets), "tenx" (flips and quarter turns; Visium)
and "none". PyTorch runs eagerly, so the step is a plain function that
updates the state in place and returns the loss tensor (no host sync).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch.profiler import record_function

from mclstexp_tpu_torch.core.losses import symmetric_infonce
from mclstexp_tpu_torch.ops import augment
from mclstexp_tpu_torch.train.state import TrainState

AUGMENT_MODES = ("st", "tenx", "none")


def make_train_step(augment_mode: str = "st", rot_impl: str = "paeth",
                    tenx_raw_scale: bool = False) -> Callable:
    """Build the step: (state, batch, draws) -> loss.

    batch: {"image_u8": (B, P, P, 3) uint8, "expression": (B, G) float32,
    "position": (B, 2) int}, on the model's device. draws: the
    ``augment.StDraws`` of this batch for "st", its ``augment.TenxDraws``
    for "tenx", ignored for "none". ``tenx_raw_scale`` feeds the "tenx"
    images on the raw 0-255 scale (``DataConfig.visium_raw_scale``).
    """
    if augment_mode not in AUGMENT_MODES:
        raise NotImplementedError(
            f"augment_mode {augment_mode!r}: the port has {AUGMENT_MODES}"
        )

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             draws: Optional[augment.StDraws | augment.TenxDraws] = None) -> torch.Tensor:
        # The named ranges label the step's phases in a torch.profiler
        # trace (profile_step.py).
        with record_function("augment"):
            if augment_mode == "st":
                images = augment.train_augment_inline(batch["image_u8"], draws,
                                                      rot_impl=rot_impl)
            elif augment_mode == "tenx":
                images = augment.tenx_augment(batch["image_u8"], draws,
                                              raw_scale=tenx_raw_scale)
            else:
                images = augment.to_float(batch["image_u8"])
        model = state.model
        model.train()
        with record_function("forward"):
            image_emb, spot_emb = model(
                {"image": images, "expression": batch["expression"],
                 "position": batch["position"]}
            )
            loss = symmetric_infonce(spot_emb, image_emb, model.config.temperature)
        with record_function("backward"):
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        with record_function("optimizer"):
            state.optimizer.step()
        state.step += 1
        return loss.detach()

    return step
