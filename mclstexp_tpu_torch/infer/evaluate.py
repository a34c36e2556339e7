"""Leave-one-out retrieval evaluation (the reference's phase B).

Port of ``mclstexp_tpu/infer/evaluate.py``. Per fold: the queries are the
held-out section's image embeddings; the keys are every other section's
spot embeddings and expression profiles; the prediction is the 1/d^2
weighted average of the top-K keys' expression; the metrics are the mean
per-gene PCC over the panel (NaN-dropped) and over the 50 HEGs, MSE and
MAE, averaged over folds by the caller.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from mclstexp_tpu_torch.infer.metrics import (
    expression_metrics,
    expression_metrics_device,
    heg_indices,
)
from mclstexp_tpu_torch.ops.retrieval import retrieve_and_aggregate


def _save_prediction(path: str, pred_expr) -> None:
    # dirname('') of a bare file name would make makedirs fail
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if isinstance(pred_expr, torch.Tensor):
        pred_expr = pred_expr.cpu().numpy()
    np.save(path, np.asarray(pred_expr).T)  # the reference's genes x spots layout


def evaluate_fold(
    fold: int,
    image_embeddings: np.ndarray,  # (N_f, P): the held-out section, the fold's model
    spot_embeddings: Sequence[np.ndarray],  # per section (N_i, P), the fold's model
    expressions: Sequence[np.ndarray],  # per section (N_i, G), ground truth
    top_k: int,
    weight_ord: int = 1,
    prediction_path: Optional[str] = None,
    device="cuda",
) -> Dict[str, float]:
    """One fold over host arrays: the kept sections are concatenated into
    the key set, retrieval runs on ``device``, the metrics on the host."""
    spot_key = np.concatenate([e for i, e in enumerate(spot_embeddings) if i != fold], axis=0)
    expression_key = np.concatenate([e for i, e in enumerate(expressions) if i != fold], axis=0)
    _, pred_expr = retrieve_and_aggregate(spot_key, expression_key, image_embeddings,
                                          top_k=top_k, weight_ord=weight_ord, device=device)
    if prediction_path:
        _save_prediction(prediction_path, pred_expr)
    return expression_metrics(pred_expr, expressions[fold])


def section_bounds(sizes: Sequence[int]) -> List[tuple]:
    """[(start, stop)] of each section inside the concatenated arrays."""
    out, start = [], 0
    for n in sizes:
        out.append((start, start + n))
        start += n
    return out


def evaluate_fold_resident(
    fold: int,
    image_embeddings_full,  # (N_total, P), every section: tensor or ndarray
    spot_embeddings_full,  # (N_total, P), every section
    expressions_full,  # (N_total, G) ground truth, on the device
    bounds: Sequence[tuple],  # per-section (start, stop)
    expression_gt: np.ndarray,  # (N_fold, G) host ground truth for the metrics
    top_k: int,
    weight_ord: int = 1,
    prediction_path: Optional[str] = None,
    device_metrics: bool = False,
    device="cuda",
) -> Dict[str, float]:
    """``evaluate_fold`` over one key set that stays on the device for every
    fold: the held-out section is excluded by a key mask instead of a
    re-concatenation (masked rows never enter the top-K, so the selection
    is the same).

    device_metrics=True reduces on the device as well
    (``expression_metrics_device``, fp32): the (N_fold, G) prediction stays
    there and the fold returns four scalars. The HEG choice still comes from
    the host ground truth, so the reference's argsort tie-break holds.
    """
    start, stop = bounds[fold]
    mask = np.ones(spot_embeddings_full.shape[0], bool)
    mask[start:stop] = False
    _, pred_expr = retrieve_and_aggregate(
        spot_embeddings_full, expressions_full, image_embeddings_full[start:stop],
        top_k=top_k, weight_ord=weight_ord, key_mask=mask, as_device=device_metrics,
        device=device,
    )
    if prediction_path:
        _save_prediction(prediction_path, pred_expr)
    if device_metrics:
        gt = expressions_full[start:stop]
        if not isinstance(gt, torch.Tensor):
            gt = torch.as_tensor(np.asarray(gt), device=pred_expr.device)
        return expression_metrics_device(pred_expr, gt.to(pred_expr.device),
                                         heg_indices(expression_gt, 50))
    return expression_metrics(pred_expr, expression_gt)


def load_reference_embeddings(embedding_dir: str, num_sections: int,
                              fold: int) -> tuple[np.ndarray, List[np.ndarray]]:
    """One fold's dump in the reference layout: transposed per-section
    ``spot_embeddings_{i+1}.npy`` (P, N_i) and the held-out section's
    ``img_embeddings_{fold+1}.npy``. Returns (image queries (N_f, P),
    per-section spot embeddings [(N_i, P)])."""
    spots = [
        np.asarray(np.load(os.path.join(embedding_dir, f"spot_embeddings_{i + 1}.npy")).T,
                   dtype=np.float32)
        for i in range(num_sections)
    ]
    image_query = np.asarray(
        np.load(os.path.join(embedding_dir, f"img_embeddings_{fold + 1}.npy")).T,
        dtype=np.float32)
    return image_query, spots


def evaluate_from_embedding_dumps(
    root: str,
    expressions: Sequence[np.ndarray],
    top_k: int,
    weight_ord: int = 1,
    folds: Optional[Sequence[int]] = None,
    prediction_dir: Optional[str] = None,
    section_names: Optional[Sequence[str]] = None,
    device="cuda",
) -> Dict[str, object]:
    """Score per-fold embedding dumps without a model: ``root`` holds
    ``embeddings_{fold}/`` directories in the reference layout (written by
    the reference, the JAX package or ``embed.dump_embeddings``);
    ``expressions`` are the per-section (N_i, G) ground truths in the same
    section order. Returns {"per_fold", "avg", "folds"}."""
    n = len(expressions)
    folds = list(range(n)) if folds is None else list(folds)
    per_fold = []
    for fold in folds:
        image_query, spots = load_reference_embeddings(
            os.path.join(root, f"embeddings_{fold}"), n, fold)
        bad = [(i, spots[i].shape[0], expressions[i].shape[0])
               for i in range(n) if spots[i].shape[0] != expressions[i].shape[0]]
        if bad:
            raise ValueError("embedding dump / ground-truth spot-count mismatch (section, "
                             f"dumped, expected): {bad[:5]}; section order misaligned?")
        pred_path = None
        if prediction_dir and section_names:
            pred_path = os.path.join(prediction_dir, section_names[fold],
                                     "matched_spot_expression_pred.npy")
        per_fold.append(evaluate_fold(fold, image_query, spots, expressions, top_k=top_k,
                                      weight_ord=weight_ord, prediction_path=pred_path,
                                      device=device))
    avg = {k: float(np.mean([m[k] for m in per_fold])) for k in per_fold[0]}
    return {"per_fold": per_fold, "avg": avg, "folds": folds}
