"""Sharded top-K retrieval + aggregation: the multi-card serving path.

Port of ``mclstexp_tpu/ops/retrieval_sharded.py``. ``ops/retrieval.py``
keeps the whole key set on one card; here the KEY database is split over
the ranks of a mesh axis, each rank holding one contiguous slab:

  1. each rank scores the (replicated) query chunk against its slab and
     keeps its local top-K (``find_matches``, or ``streaming_topk`` past
     ``STREAMING_SCORE_ELEMENTS`` score elements per slab);
  2. one ``all_gather`` of the values and *global* indices, merged in rank
     order by ``topk_lowest_index``: slabs are contiguous index ranges and
     each slab's candidates come sorted with ties to the lowest index, so
     ties go to the lowest global index, as in the dense path and JAX;
  3. each winner's embedding and expression row comes from the rank that
     owns it: a masked local gather (zeros elsewhere) summed by
     ``all_reduce`` (exact: one term is the row, the others 0);
  4. the weighting (``aggregate_from_selected``) runs on every rank on the
     gathered (C, K, ·) tiles: the single-card math.

The local top-K, the merge and the row fetch are functions of per-shard
tensors (``local_topk``, ``merge_candidates``, ``owned_rows``), so that one
process can run them over any number of simulated shards (the tests do).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mclstexp_tpu_torch.ops.retrieval import (
    STREAMING_SCORE_ELEMENTS,
    _as_tensor,
    aggregate_from_selected,
    find_matches,
    streaming_topk,
    topk_lowest_index,
)
from mclstexp_tpu_torch.parallel.mesh import mesh_axis


def local_topk(k_shard: torch.Tensor, valid_shard: torch.Tensor, q: torch.Tensor, kk: int,
               streaming: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """One slab's cosine top-``kk`` of the queries ``q`` (C, D): (values,
    local indices), each (C, kk); rows with ``valid_shard`` False score
    -inf."""
    if streaming:
        return streaming_topk(k_shard, q, kk, key_mask=valid_shard)
    return find_matches(k_shard, q, kk, key_mask=valid_shard)


def merge_candidates(vals: Sequence[torch.Tensor], global_idx: Sequence[torch.Tensor],
                     top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The global top-``top_k`` from the slabs' candidates, given in rank
    order ((C, kk) each): (values, global indices), ties to the lowest
    global index."""
    av, ai = torch.cat(list(vals), dim=1), torch.cat(list(global_idx), dim=1)
    top, pos = topk_lowest_index(av, top_k)
    return top, torch.gather(ai, 1, pos)


def owned_rows(shard: torch.Tensor, idx: torch.Tensor, rank: int,
               s_per_dev: int) -> torch.Tensor:
    """Rows ``idx`` (C, K) of the full key set that slab ``rank`` holds,
    zeros where another slab holds them: (C, K, F)."""
    local = idx - rank * s_per_dev
    owned = (local >= 0) & (local < s_per_dev)
    rows = shard[local.clamp(0, s_per_dev - 1)]
    return torch.where(owned[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                           device=rows.device))


def _n_active(nk: int, key_mask, key_mask_count) -> int:
    if key_mask is None:
        return nk
    if key_mask_count is not None:
        return int(key_mask_count)
    if isinstance(key_mask, torch.Tensor):
        return int(key_mask.sum())
    return int(np.asarray(key_mask).sum())


def sharded_retrieve_and_aggregate(
    key_emb,
    key_expr,
    query_emb,
    top_k: int,
    mesh,
    weight_ord: int = 1,
    axis: str = "data",
    key_mask=None,
    query_chunk: int = 512,
    key_mask_count=None,
    return_matches: bool = False,
    local_streaming=None,
    device="cuda",
):
    """``retrieve_and_aggregate`` with the key database split over the ranks
    of ``mesh``'s ``axis``: the same selection (ties included) and an
    fp32-tight aggregation, each rank's memory and work divided by the axis
    size. Every rank of the mesh calls it with the same arguments and gets
    the same host ndarrays back.

    key_emb (Nk, D), key_expr (Nk, G), query_emb (Nq, D): ndarrays or
    tensors; each rank moves only its slab of the keys to ``device`` (keys
    padded to a multiple of the axis size with invalid rows). K is clamped
    to the active keys (``key_mask``; ``key_mask_count`` saves its readback)
    and none active raises ``ValueError``. Queries go in padded chunks of
    ``query_chunk``. ``local_streaming=None`` switches each slab's top-K to
    ``streaming_topk`` past ``STREAMING_SCORE_ELEMENTS`` (query_chunk x slab
    length); True/False forces it. Returns (pred_emb, pred_expr), with the
    scores and global indices first under ``return_matches``."""
    device = torch.device(device)
    group, n_dev, me = mesh_axis(mesh, axis)
    nk = key_emb.shape[0]
    n_active = _n_active(nk, key_mask, key_mask_count)
    if n_active == 0:
        raise ValueError("key_mask deactivates every retrievable key")
    top_k = min(top_k, n_active)

    s = -(-nk // n_dev)
    lo, hi = min(me * s, nk), min((me + 1) * s, nk)

    def slab(a, dtype, fill):
        a = a[lo:hi] if isinstance(a, torch.Tensor) else np.asarray(a)[lo:hi]
        a = _as_tensor(a, dtype, device)
        if a.shape[0] < s:
            a = torch.cat([a, a.new_full((s - a.shape[0],) + tuple(a.shape[1:]), fill)])
        return a

    k_dev = slab(key_emb, torch.float32, 0.0)
    e_dev = slab(key_expr, torch.float32, 0.0)
    v_dev = slab(np.ones(nk, bool) if key_mask is None else key_mask, torch.bool, False)
    if local_streaming is None:
        local_streaming = query_chunk * s > STREAMING_SCORE_ELEMENTS
    kk = min(top_k, s)

    query = _as_tensor(query_emb, torch.float32, device)
    nq = query.shape[0]
    outs = []
    for start in range(0, nq, query_chunk):
        q = query[start:start + query_chunk]
        b = q.shape[0]
        if b < query_chunk:  # the one chunk shape; zero queries are sliced off
            q = torch.cat([q, q.new_zeros((query_chunk - b, q.shape[1]))])
        lv, li = local_topk(k_dev, v_dev, q, kk, bool(local_streaming))
        av = [torch.empty_like(lv) for _ in range(n_dev)]
        ai = [torch.empty_like(li) for _ in range(n_dev)]
        dist.all_gather(av, lv, group=group)
        dist.all_gather(ai, li + me * s, group=group)
        vals, idx = merge_candidates(av, ai, top_k)
        sel_emb = owned_rows(k_dev, idx, me, s)
        sel_expr = owned_rows(e_dev, idx, me, s)
        dist.all_reduce(sel_emb, group=group)
        dist.all_reduce(sel_expr, group=group)
        pe, px = aggregate_from_selected(sel_emb, sel_expr, q, weight_ord)
        outs.append([t[:b].cpu().numpy() for t in (vals, idx, pe, px)])
    vals, idx, pred_emb, pred_expr = (np.concatenate(parts, axis=0) for parts in zip(*outs))
    if return_matches:
        return vals, idx, pred_emb, pred_expr
    return pred_emb, pred_expr
