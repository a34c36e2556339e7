"""Baseline losses: the NB / ZINB likelihoods of Hist2ST and BLEEP's CLIP loss.

Port of ``mclstexp_tpu/baselines/losses.py`` (all fp32):
  * ``nb_loss``: negative binomial NLL in the (log-r, logit-p)
    parameterization of Hist2ST's NB heads (reference ``baselines/His2ST/
    NB_module.py:18-24``);
  * ``zinb_loss``: zero-inflated NB NLL on (mean, dispersion, pi) with per-spot
    size factors (``NB_module.py:26-46``);
  * ``mean_act``, ``disp_act``: the ZINB heads' activations;
  * ``bleep_clip_loss``: CLIP loss with soft targets, the softmax of the
    averaged intra-modal similarities (``baselines/Bleep/models.py:34-43``);
    ``bleep_clip_loss_gathered`` the same over a data-parallel step's
    global batch.

With a ``mask`` (N,) over spots, padded rows contribute nothing, so a
bucket-padded slide's loss and gradients are the unpadded slide's. The
zero-count case is selected by ``torch.where`` over both branches, as JAX's
``jnp.where``, so the gradient at zero counts comes out as JAX's does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from mclstexp_tpu_torch.core.losses import soft_target_cross_entropy
from mclstexp_tpu_torch.parallel.collectives import gather_rows


def _masked_mean(per: torch.Tensor, mask: Optional[torch.Tensor], width: int) -> torch.Tensor:
    """sum(per * mask) / max(sum(mask) * width, 1) over rows; the plain mean
    without a mask."""
    if mask is None:
        return per.mean()
    w = mask.float().view((-1,) + (1,) * (per.ndim - 1))
    return (per * w).sum() / torch.clamp(w.sum() * width, min=1.0)


def nb_loss(x: torch.Tensor, log_r: torch.Tensor, logit_p: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NB NLL; x raw counts (N, G), the heads emit log-dispersion r and logit p."""
    x = x.float()
    r = torch.exp(log_r)
    ll = torch.lgamma(r + x) - torch.lgamma(r)
    ll = ll + (logit_p * x - torch.log1p(torch.exp(logit_p)) * (x + r))
    return _masked_mean(-ll.sum(dim=-1), mask, 1)


def zinb_loss(x: torch.Tensor, mean: torch.Tensor, disp: torch.Tensor, pi: torch.Tensor,
              scale_factor: torch.Tensor, ridge_lambda: float = 0.0, eps: float = 1e-10,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ZINB NLL; mean, disp positive, pi in (0, 1), scale_factor (N,). With a
    mask the mean runs over the real rows' sum(mask) * G elements."""
    x = x.float()
    mean = mean * scale_factor[:, None]
    t1 = torch.lgamma(disp + eps) + torch.lgamma(x + 1.0) - torch.lgamma(x + disp + eps)
    t2 = (disp + x) * torch.log1p(mean / (disp + eps)) + x * (
        torch.log(disp + eps) - torch.log(mean + eps))
    nb_case = t1 + t2 - torch.log(1.0 - pi + eps)
    zero_nb = torch.pow(disp / (disp + mean + eps), disp)
    zero_case = -torch.log(pi + (1.0 - pi) * zero_nb + eps)
    out = torch.where(x <= 1e-8, zero_case, nb_case)
    if ridge_lambda > 0:
        out = out + ridge_lambda * pi.square()
    return _masked_mean(out, mask, out.shape[1])


def mean_act(x: torch.Tensor) -> torch.Tensor:
    """ZINB mean head activation: clamp(exp(x), 1e-5, 1e6)."""
    return torch.clamp(torch.exp(x), 1e-5, 1e6)


def disp_act(x: torch.Tensor) -> torch.Tensor:
    """ZINB dispersion head activation: clamp(softplus(x), 1e-4, 1e4)."""
    return torch.clamp(F.softplus(x), 1e-4, 1e4)


def bleep_clip_loss(spot_emb: torch.Tensor, image_emb: torch.Tensor,
                    temperature: float = 1.0) -> torch.Tensor:
    """Cross-modal logits spot @ image^T / T against soft targets, the
    row softmax of the mean of the two intra-modal similarity matrices over
    T; the mean of the spot-side and image-side cross-entropies."""
    spot_emb, image_emb = spot_emb.float(), image_emb.float()
    logits = (spot_emb @ image_emb.T) / temperature
    img_sim = image_emb @ image_emb.T
    spot_sim = spot_emb @ spot_emb.T
    targets = torch.softmax(((img_sim + spot_sim) / 2.0) / temperature, dim=-1)
    spots_loss = soft_target_cross_entropy(logits, targets)
    images_loss = soft_target_cross_entropy(logits.T, targets.T)
    return (spots_loss + images_loss) / 2.0


def bleep_clip_loss_gathered(spot_emb: torch.Tensor, image_emb: torch.Tensor,
                             temperature: float, group) -> torch.Tensor:
    """BLEEP's loss over the global batch from each rank's (b, P) rows: both
    embeddings gathered over ``group`` (``parallel.collectives.gather_rows``,
    with its gradient), so the soft targets' intra-modal similarities and the
    cross-modal logits span every rank's rows, as one process's do; the
    reference's DDP takes the loss over each rank's rows instead. The same
    scalar on every rank."""
    return bleep_clip_loss(gather_rows(spot_emb, group), gather_rows(image_emb, group),
                           temperature)
