"""Shared building blocks for the image towers (NCHW inside the port).

Port of ``mclstexp_tpu/models/image/common.py``. The JAX build needs its own
``BatchNormT`` to store the UNBIASED batch variance in the running stats
while normalizing with the biased one; that is exactly what torch's
``BatchNorm2d`` does, and its momentum 0.1 is the JAX build's EMA 0.9.
"""

from __future__ import annotations

import torch
from torch import nn


def BatchNormT(channels: int, device=None) -> nn.BatchNorm2d:
    """BatchNorm with torch running-stat semantics (eps 1e-5, momentum 0.1)."""
    return nn.BatchNorm2d(channels, eps=1e-5, momentum=0.1, device=device)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Adaptive average pool to (1, 1) then flatten: (B, C, H, W) -> (B, C)."""
    return x.mean(dim=(2, 3))


def max_pool_3x3_s2() -> nn.MaxPool2d:
    """torch MaxPool2d(3, stride=2, padding=1), the stem's pool."""
    return nn.MaxPool2d(3, stride=2, padding=1)
