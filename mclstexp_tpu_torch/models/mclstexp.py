"""Flagship contrastive model: image tower + spot tower + projection heads.

Port of ``mclstexp_tpu/models/mclstexp.py``: the product variant
("attention") and the MLP ablation ("mlp", no spot transformer). Attribute
names are the reference torch ones, including the mlp variant's
``image_ecode`` typo, so a reference-layout ``state_dict`` (from
``interop.params_from_jax`` or the JAX exporter) loads with ``strict=True``;
the ViT towers' blocks are the port's ``AttnBlock``, whose keys
``models/image/torch_import.py`` maps from timm's.

``forward`` returns the pair of (B, P) projected embeddings; the loss lives
in ``core.losses``. ``config.dropout`` is live, as in the JAX build.

``config.dtype`` "bfloat16" is the JAX rule: parameters fp32, the towers
and heads computing in bf16 (``core.layers.set_compute_dtype``), the
embeddings returned in fp32, so InfoNCE and the optimizer are unchanged.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from mclstexp_tpu_torch.config import ModelConfig
from mclstexp_tpu_torch.core.layers import (
    PositionTables,
    ProjectionHead,
    compute_dtype_of,
    set_compute_dtype,
    widen,
)
from mclstexp_tpu_torch.models.image.registry import build_encoder
from mclstexp_tpu_torch.models.spot import SpotEncoder


class MclSTExp(PositionTables):
    """Two-tower contrastive model.

    Inputs (the JAX build's batch dict):
      image:      (B, H, W, 3) float in [0, 1], NHWC
      expression: (B, G) log-CPM HVG expression
      position:   (B, 2) integer (x, y) coords
    """

    def __init__(self, config: ModelConfig, device="cuda"):
        super().__init__(config.pos_vocab, config.spot_dim, device=device)
        cfg = self.config = config
        dtype = compute_dtype_of(cfg.dtype)
        encoder, feat_dim = build_encoder(cfg.encoder_name, device=device)
        if feat_dim != cfg.image_dim:
            raise ValueError(
                f"encoder {cfg.encoder_name!r} emits {feat_dim}-d features but "
                f"config.image_dim={cfg.image_dim}"
            )
        if cfg.variant == "attention":
            self.image_encoder = encoder
            self.spot_encoder = SpotEncoder(
                cfg.spot_dim, cfg.heads_num, cfg.heads_dim, cfg.head_layers,
                cfg.dropout, device=device, backend=cfg.attn_backend,
            )
        elif cfg.variant == "mlp":
            self.image_ecode = encoder  # the reference's attribute name
        else:
            raise ValueError(f"unknown variant {cfg.variant!r}")
        self.image_projection = ProjectionHead(cfg.image_dim, cfg.projection_dim,
                                               cfg.dropout, device=device)
        self.spot_projection = ProjectionHead(cfg.spot_dim, cfg.projection_dim,
                                              cfg.dropout, device=device)
        set_compute_dtype(self, dtype)

    @property
    def tower(self) -> nn.Module:
        return self.image_encoder if self.config.variant == "attention" else self.image_ecode

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        return widen(self.image_projection(self.tower(images)))

    def encode_spots(self, expression: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        feats = expression + self.position_embed(positions)
        if self.config.variant == "attention":
            feats = self.spot_encoder(feats)
        return widen(self.spot_projection(feats))

    def forward(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        image_emb = self.encode_image(batch["image"])
        spot_emb = self.encode_spots(batch["expression"], batch["position"])
        return image_emb, spot_emb
