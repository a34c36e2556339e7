"""Top-K cosine retrieval + inverse-square-distance aggregation.

Port of ``mclstexp_tpu/ops/retrieval.py``: L2-normalize keys and queries,
one (Nq, Nk) score product, top-K, then weights on the K retrieved
*unnormalized* key embeddings and a weighted average of their expression.
Queries are aggregated in chunks so the gathered (chunk, K, G) expression
tile stays bounded at any key-set size. The JAX package runs all of this
as XLA ops, outside any Pallas kernel; so does the port (``torch.matmul``,
``torch.topk``, gathers).

Tie-break: among exactly tied scores ``lax.top_k`` returns the lowest
indices, in index order; ``torch.topk`` leaves tie order unspecified, on
the card too. ``topk_lowest_index`` takes ``torch.topk`` and repairs every
row that holds a tie (inside the K, or at the K-th value with more tied
candidates outside) with a stable descending sort of that row, so both the
dense path and the streaming merge select exactly what the JAX package
selects.

Distance conventions: weights 1/d^2 with d the L1 distance (her2st,
``weight_ord=1``) or L2 (cSCC/Visium, 2), uniform (0, BLEEP "average"), or
BLEEP's exp(-(d^2 - d_top^2 + 1)) (-1), on unnormalized embeddings.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

Array = "np.ndarray | torch.Tensor"


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """torch ``F.normalize`` semantics: x / max(||x||, eps)."""
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(eps)


def topk_lowest_index(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise top-``k`` of (R, C) scores, descending, ties to the lowest
    column (``lax.top_k``'s order). Returns (values, int64 columns)."""
    vals, idx = torch.topk(scores, k, dim=1, sorted=True)
    kth = vals[:, -1:]
    tied = (vals[:, 1:] == vals[:, :-1]).any(dim=1)
    tied |= (scores == kth).sum(dim=1) > (vals == kth).sum(dim=1)
    rows = tied.nonzero().squeeze(1)
    if rows.numel():
        sv, si = torch.sort(scores[rows], dim=1, descending=True, stable=True)
        vals[rows], idx[rows] = sv[:, :k], si[:, :k]
    return vals, idx


def find_matches(key_emb: torch.Tensor, query_emb: torch.Tensor, top_k: int,
                 key_mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cosine top-K: (values, indices), each (Nq, top_k).

    key_emb (Nk, D) reference spot embeddings, query_emb (Nq, D) image
    embeddings, both normalized here. key_mask: optional (Nk,) bool; False
    rows score -inf and are never retrieved while K <= the active count
    (the LOO protocol keeps the full key set on the device and masks the
    held-out section).
    """
    k = l2_normalize(key_emb.float())
    q = l2_normalize(query_emb.float())
    scores = q @ k.T
    if key_mask is not None:
        scores = scores.masked_fill(~key_mask.bool()[None, :], float("-inf"))
    return topk_lowest_index(scores, top_k)


def streaming_topk(key_emb: torch.Tensor, query_emb: torch.Tensor, top_k: int,
                   chunk_size: int = 4096, key_mask: Optional[torch.Tensor] = None,
                   bf16: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Memory-bounded cosine top-K: keys in chunks of ``chunk_size``, each
    (Nq, C) score block merged into a running (Nq, top_k) buffer by a top-K
    over the buffer followed by the chunk. Peak memory O(Nq * (top_k + C));
    the same selection as ``find_matches``, ties included.

    bf16: round the L2-normalized keys and queries to bfloat16 (normalized
    in fp32 first); the products of bf16 values are exact in fp32 and are
    summed in fp32, so the scores are the fp32-accumulated scores of the
    bf16 inputs, as in the JAX package's bf16 mode.
    """
    q = l2_normalize(query_emb.float())
    k = l2_normalize(key_emb.float())
    if bf16:
        q = q.bfloat16().float()
        k = k.bfloat16().float()
    nk, nq = k.shape[0], q.shape[0]
    dev = q.device
    valid = (torch.ones(nk, dtype=torch.bool, device=dev) if key_mask is None
             else key_mask.to(dev).bool())
    vals = torch.full((nq, top_k), float("-inf"), device=dev)
    idx = torch.zeros((nq, top_k), dtype=torch.int64, device=dev)
    n_chunks = -(-nk // chunk_size)
    for c in range(n_chunks):
        start = c * chunk_size
        k_chunk = k[start:start + chunk_size]
        scores = (q @ k_chunk.T).masked_fill(~valid[None, start:start + chunk_size],
                                             float("-inf"))
        # The JAX scan pads the last chunk with masked keys; they score -inf
        # and can only be chosen where a row has too few keys, in place of
        # the buffer's own -inf entries that precede them.
        pad = chunk_size - scores.shape[1]
        cand_idx = torch.arange(start, start + chunk_size, device=dev).expand(nq, -1)
        if pad:
            scores = torch.cat([scores, scores.new_full((nq, pad), float("-inf"))], dim=1)
        all_vals = torch.cat([vals, scores], dim=1)
        all_idx = torch.cat([idx, cand_idx], dim=1)
        vals, pos = topk_lowest_index(all_vals, top_k)
        idx = torch.gather(all_idx, 1, pos)
    return vals, idx


def aggregate_from_selected(sel_emb: torch.Tensor, sel_expr: torch.Tensor,
                            query_chunk: torch.Tensor,
                            weight_ord: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Protocol weights over gathered top-K tiles and the weighted average:
    sel_emb (C, K, D) retrieved unnormalized embeddings, sel_expr (C, K, G)
    their expression, query_chunk (C, D) unnormalized queries."""
    if weight_ord == 0:
        w = torch.full(sel_emb.shape[:2], 1.0 / sel_emb.shape[1], device=sel_emb.device)
    elif weight_ord == -1:
        d2 = (sel_emb - query_chunk[:, None, :]).square().sum(dim=-1)  # (C, K)
        w = torch.exp(-(d2 - d2[:, :1] + 1.0))
        w = w / w.sum(dim=-1, keepdim=True)
    else:
        diff = sel_emb - query_chunk[:, None, :]
        if weight_ord == 1:
            d = diff.abs().sum(dim=-1)
        else:
            d = diff.square().sum(dim=-1).sqrt()
        w = 1.0 / d.square()
        w = w / w.sum(dim=-1, keepdim=True)
    pred_emb = torch.einsum("ck,ckd->cd", w, sel_emb)
    pred_expr = torch.einsum("ck,ckg->cg", w, sel_expr)
    return pred_emb, pred_expr


# Above this many score-matrix elements the dense (Nq, Nk) product is
# ~>2 GB fp32 and streaming_topk takes over (the same selection; peak memory
# O(Nq * (top_k + chunk))).
STREAMING_SCORE_ELEMENTS = 512 * 1024 * 1024


def _as_tensor(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def retrieve_and_aggregate(
    key_emb: Array,
    key_expr: Array,
    query_emb: Array,
    top_k: int,
    weight_ord: int = 1,
    chunk_size: int = 1024,
    streaming: Optional[bool] = None,
    key_mask=None,
    streaming_bf16: bool = False,
    as_device: bool = False,
    device="cuda",
):
    """Retrieval inference: (pred_embeddings (Nq, D), pred_expression
    (Nq, G)), host ndarrays by default, tensors on ``device`` under
    ``as_device=True``.

    key_emb (Nk, D), key_expr (Nk, G), query_emb (Nq, D): ndarrays or
    tensors (a tensor already on ``device`` is used in place). K is clamped
    to the retrievable key count: past it the top-K would hold -inf-scored
    masked rows whose finite weights leak them into the prediction (for the
    LOO protocol, the held-out section's own spots). ``streaming=None``
    switches to ``streaming_topk`` past ``STREAMING_SCORE_ELEMENTS`` score
    elements; True/False forces the choice. ``streaming_bf16`` applies to
    the streaming path only; aggregation stays fp32 on the unnormalized
    embeddings.
    """
    device = torch.device(device)
    key_emb_t = _as_tensor(key_emb, torch.float32, device)
    key_expr_t = _as_tensor(key_expr, torch.float32, device)
    query_t = _as_tensor(query_emb, torch.float32, device)
    nq, nk = query_t.shape[0], key_emb_t.shape[0]
    mask_t = None if key_mask is None else _as_tensor(key_mask, torch.bool, device)

    if key_mask is None:
        n_active = nk
    elif isinstance(key_mask, torch.Tensor):
        n_active = int(key_mask.sum())
    else:
        n_active = int(np.asarray(key_mask).sum())
    if n_active == 0:
        raise ValueError("key_mask deactivates every retrievable key")
    top_k = min(top_k, n_active)

    if streaming is None:
        streaming = nq * nk > STREAMING_SCORE_ELEMENTS
    if streaming:
        _, indices = streaming_topk(key_emb_t, query_t, top_k, key_mask=mask_t,
                                    bf16=streaming_bf16)
    else:
        _, indices = find_matches(key_emb_t, query_t, top_k, key_mask=mask_t)

    pred_embs, pred_exprs = [], []
    for start in range(0, nq, chunk_size):
        sel = indices[start:start + chunk_size]
        pe, px = aggregate_from_selected(key_emb_t[sel], key_expr_t[sel],
                                         query_t[start:start + chunk_size], weight_ord)
        pred_embs.append(pe)
        pred_exprs.append(px)
    pred_emb, pred_expr = torch.cat(pred_embs), torch.cat(pred_exprs)
    if as_device:
        return pred_emb, pred_expr
    return pred_emb.cpu().numpy(), pred_expr.cpu().numpy()
