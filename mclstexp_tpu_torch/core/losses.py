"""Contrastive loss (fp32), port of ``mclstexp_tpu/core/losses.py``.

With spot and image embeddings of one batch, logits = spot @ image.T / T;
the loss is soft-target cross-entropy against the identity matrix, averaged
over both directions. The embeddings are *unnormalized*, as in the reference.

In a data-parallel step the logit matrix spans the *global* batch:
``symmetric_infonce_gathered`` gathers both towers' rows from every rank
first (``parallel.collectives.gather_rows``, with its gradient), as JAX's
does from inside ``shard_map``.
"""

from __future__ import annotations

import torch

from mclstexp_tpu_torch.parallel.collectives import gather_rows


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


def symmetric_infonce_gathered(spot_emb: torch.Tensor, image_emb: torch.Tensor,
                               temperature: float, group) -> torch.Tensor:
    """Global-batch InfoNCE from each rank's (b, D) rows: both embeddings
    gathered over ``group`` in rank order, so the B x B logits and their
    softmax normalizers see the global batch. Returns the same scalar on
    every rank; its gradient reaches each rank's rows summed over the ranks
    (``collectives.average_gradients`` divides it back)."""
    return symmetric_infonce(gather_rows(spot_emb, group), gather_rows(image_emb, group),
                             temperature)
