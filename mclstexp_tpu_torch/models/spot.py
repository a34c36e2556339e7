"""Spot tower: the attention blocks over expression + position features.

Port of ``mclstexp_tpu/models/spot.py``. The *whole minibatch is one
attention sequence*: (B, G) features become (1, B, G), so the spot encoder
mixes information across the batch, as in the reference. The position
tables are the model's top-level ``x_embed``/``y_embed`` (reference keys),
so the caller adds them before this tower; the blocks sit at
``spot_encoder.<i>`` as in the reference's ``nn.Sequential``.
"""

from __future__ import annotations

import torch
from torch import nn

from mclstexp_tpu_torch.core.layers import AttnBlock


class SpotEncoder(nn.Sequential):
    def __init__(self, spot_dim: int, heads_num: int = 8, heads_dim: int = 64,
                 head_layers: int = 2, dropout: float = 0.0, device=None,
                 backend: str = "xla"):
        super().__init__(*(
            AttnBlock(spot_dim, heads_num, heads_dim, mlp_dim=spot_dim,
                      dropout=dropout, device=device, backend=backend)
            for _ in range(head_layers)
        ))

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        """(B, G) spot features -> (B, G), the batch as one sequence."""
        x = feats[None]
        for block in self:
            x = block(x)
        return x[0]
