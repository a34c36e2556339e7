"""Shared building blocks for the image towers (NCHW inside the port).

Port of ``mclstexp_tpu/models/image/common.py``. The JAX build needs its own
``BatchNormT`` to store the UNBIASED batch variance in the running stats
while normalizing with the biased one; that is exactly what torch's
``BatchNorm2d`` does, and its momentum 0.1 is the JAX build's EMA 0.9. The
image towers use it as it is. ``MaskedBatchNormT`` is the JAX module with
its ``mask`` argument, which the slide baselines pass (padded slides).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def BatchNormT(channels: int, device=None) -> nn.BatchNorm2d:
    """BatchNorm with torch running-stat semantics (eps 1e-5, momentum 0.1)."""
    return nn.BatchNorm2d(channels, eps=1e-5, momentum=0.1, device=device)


class MaskedBatchNormT(nn.Module):
    """The JAX ``BatchNormT`` (``models/image/common.py:25-93``) with its
    ``mask``: channels on dim 1 of (B, C, ...) inputs; in train mode the
    statistics are taken over the samples (leading axis) that ``mask``
    marks, all of them without one, as a two-pass variance; the running
    stats move by the 0.9 EMA toward the mean and the UNBIASED variance (n /
    (n - 1), n the count of reduced elements). Masking the padded samples
    out makes a padded slide's train-mode forward equal the unpadded one on
    every real row. At eval the running stats serve and the mask is a no-op.
    eps 1e-5. Keys as ``BatchNorm2d``'s (``weight``, ``bias``,
    ``running_mean``, ``running_var``, ``num_batches_tracked``)."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.momentum, self.eps = 0.9, 1e-5
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("running_mean", torch.zeros(channels, device=device))
        self.register_buffer("running_var", torch.ones(channels, device=device))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long, device=device))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.ndim - 2)  # per channel, broadcast over (B, C, ...)
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            axes = (0,) + tuple(range(2, x.ndim))
            if mask is None:
                n = x.numel() // x.shape[1]
                mean = x.mean(axes)
                var = (x - mean.view(shape)).square().mean(axes)
            else:
                w = mask.to(x.dtype).view((-1,) + (1,) * (x.ndim - 1))
                n = torch.clamp(w.sum() * (x[0].numel() // x.shape[1]), min=1.0)
                mean = (x * w).sum(axes) / n
                var = ((x - mean.view(shape)).square() * w).sum(axes) / n
            with torch.no_grad():
                unbiased = var * (n / max(n - 1, 1) if mask is None
                                  else n / torch.clamp(n - 1, min=1.0))
                self.running_mean.mul_(self.momentum).add_((1.0 - self.momentum) * mean)
                self.running_var.mul_(self.momentum).add_((1.0 - self.momentum) * unbiased)
                self.num_batches_tracked += 1
        inv = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * inv.view(shape) + self.bias.view(shape)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Adaptive average pool to (1, 1) then flatten: (B, C, H, W) -> (B, C)."""
    return x.mean(dim=(2, 3))


def max_pool_3x3_s2() -> nn.MaxPool2d:
    """torch MaxPool2d(3, stride=2, padding=1), the stem's pool."""
    return nn.MaxPool2d(3, stride=2, padding=1)
