"""Contrastive loss (fp32), port of ``mclstexp_tpu/core/losses.py``.

With spot and image embeddings of one batch, logits = spot @ image.T / T;
the loss is soft-target cross-entropy against the identity matrix, averaged
over both directions. The embeddings are *unnormalized*, as in the reference.
"""

from __future__ import annotations

import torch


def soft_target_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean over rows of -sum_j targets_ij * log_softmax(logits)_ij."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -(targets * logp).sum(dim=-1).mean()


def symmetric_infonce(
    spot_emb: torch.Tensor, image_emb: torch.Tensor, temperature: float = 1.0
) -> torch.Tensor:
    """Symmetric InfoNCE with identity targets over a batch.

    spot_emb, image_emb: (B, D) projections of the two towers.
    """
    logits = (spot_emb.float() @ image_emb.float().T) / temperature
    eye = torch.eye(logits.shape[0], logits.shape[1], dtype=torch.float32,
                    device=logits.device)
    spots_loss = soft_target_cross_entropy(logits, eye)
    images_loss = soft_target_cross_entropy(logits.T, eye.T)
    return (spots_loss + images_loss) / 2.0
