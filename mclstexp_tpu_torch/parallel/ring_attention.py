"""Ring self-attention: sequence-parallel attention over a mesh axis.

Port of ``mclstexp_tpu/parallel/ring_attention.py``. The spot sequence is
split into S blocks, one per rank of the axis's group; each rank keeps its
query block, and the K/V blocks rotate around the ring (rank r sends to
r + 1) while an online softmax merges one block a step, in fp32, so no
rank holds more than an (n/S, n/S) score block per head.

* ``ring_self_attention(q, k, v, group)``: JAX's function, over this
  rank's (n_local, h, d) blocks, as an autograd Function. The forward
  rotates K and V S - 1 times through ``dist.batch_isend_irecv``; it saves
  the output and each query row's log-sum-exp. The backward is a ring of
  its own: (k, v, dk, dv) rotate together while each rank adds its query
  block's share, p = exp(s - lse), dv += p^T dout, ds = p (dout v^T -
  rowsum(dout out)), dq += ds k scale, dk += ds^T q scale; after S
  rotations every dk, dv is back on the rank that owns its block. JAX
  differentiates through its ``fori_loop`` and ``ppermute``; this is the
  same function's gradient, computed analytically. A group of one rank
  sends nothing (torch refuses a send to its own rank; JAX's permutation
  ``[(0, 0)]`` is the identity): the ring is one block, dense attention.
* ``blockwise_self_attention(q, k, v, n_blocks)``: the same schedule over
  ``n_blocks`` blocks of one process's sequence, the rotation done by
  indexing: what S ranks compute, on one device.
* ``sequence_parallel_attention(q, k, v, axis, scale)``: the model's
  backend "ring" (JAX ``core/layers.py::_ring_shard_map``). The whole
  (b, n, h, d) sequence, the same on every rank of the active mesh's
  ``axis`` (``parallel.mesh.active_mesh``), is cut into the rank's block,
  the ring runs over every batch row at once (JAX ``vmap``s over b) and
  the output is all-gathered, so every rank holds the whole sequence
  again. The autograd of the gather hands each rank its block of the
  upstream gradient, which is the same on every rank (not a sum over
  ranks), and dq, dk, dv are gathered back whole, so a replicated
  ``to_qkv`` gets one process's gradient on every rank.

The block merge (``_online_softmax_step``, ``_block_grads``) is einsum
arithmetic, as JAX's is: no Pallas kernel stands behind it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from mclstexp_tpu_torch.parallel.mesh import current_mesh, mesh_axis


def _online_softmax_step(carry, k: torch.Tensor, v: torch.Tensor, q: torch.Tensor,
                         scale: float):
    """Merge one K/V block into the running (out, row_max, row_sum); fp32
    (b, n, h, d) blocks, out (b, h, q, d), the rest (b, h, q)."""
    out, m, l = carry
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)  # rescale old accumulators
    p = torch.exp(s - m_new[..., None])
    l_new = l * alpha + p.sum(dim=-1)
    out_new = out * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v)
    return out_new, m_new, l_new


def _block_grads(q, k, v, dout, lse, delta, scale: float):
    """One (query block, key block) pair's share of dq, dk and dv: fp32
    (b, n, h, d) blocks; ``lse`` and ``delta`` = rowsum(dout * out) are the
    query rows' (b, h, q)."""
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", q, k) * scale - lse[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dout, v) - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale
    return dq, dk, dv


class _GroupRing:
    """One rank's block of a ring over ``group``: rotating sends this rank's
    tensors to the next rank and takes the previous rank's."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        me = dist.get_rank(group)
        self.next = dist.get_global_rank(group, (me + 1) % self.size)
        self.prev = dist.get_global_rank(group, (me - 1) % self.size)

    def split(self, x: torch.Tensor, dim: int) -> List[torch.Tensor]:
        return [x]

    def join(self, parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
        return parts[0]

    def rotate(self, blocks: List[tuple]) -> List[tuple]:
        """``blocks``: [this rank's tuple of same-shaped, same-typed tensors]."""
        if self.size == 1:
            return blocks
        send = torch.stack(blocks[0])
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, self.next, self.group),
               dist.P2POp(dist.irecv, recv, self.prev, self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [tuple(recv.unbind(0))]


class _LocalRing:
    """``size`` ranks' blocks of one sequence in one process: block i is
    rank i's, and a rotation moves rank r's tensors to rank r + 1 by
    indexing."""

    def __init__(self, size: int):
        self.size = size

    def split(self, x: torch.Tensor, dim: int) -> List[torch.Tensor]:
        return list(x.chunk(self.size, dim=dim))

    def join(self, parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
        return torch.cat(list(parts), dim=dim)

    def rotate(self, blocks: List[tuple]) -> List[tuple]:
        return blocks[-1:] + blocks[:-1]


class _RingAttention(torch.autograd.Function):
    """Attention over (b, n, h, d) q, k, v by the ring's schedule: each
    block's rows in fp32, the output in q's dtype."""

    @staticmethod
    def forward(ctx, q, k, v, ring, scale: float):
        qs = [x.float() for x in ring.split(q, 1)]
        kv = list(zip(ring.split(k, 1), ring.split(v, 1)))
        carries = [(x.new_zeros(x.shape[0], x.shape[2], x.shape[1], x.shape[3]),
                    x.new_full((x.shape[0], x.shape[2], x.shape[1]), float("-inf")),
                    x.new_zeros(x.shape[0], x.shape[2], x.shape[1])) for x in qs]
        for step in range(ring.size):
            carries = [_online_softmax_step(c, kb.float(), vb.float(), qb, scale)
                       for c, qb, (kb, vb) in zip(carries, qs, kv)]
            if step + 1 < ring.size:  # JAX's last rotation is redundant: skipped
                kv = ring.rotate(kv)
        out = ring.join([(o / l[..., None]).transpose(1, 2) for o, _, l in carries], 1)
        lse = ring.join([m + torch.log(l) for _, m, l in carries], 2)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring, ctx.scale = ring, scale
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        ring, scale = ctx.ring, ctx.scale
        dout = dout.float()
        delta = (dout * out).sum(dim=-1).transpose(1, 2)  # (b, h, n)
        qs, douts = ring.split(q.float(), 1), ring.split(dout, 1)
        lses, deltas = ring.split(lse, 2), ring.split(delta, 2)
        dqs = [torch.zeros_like(x) for x in qs]
        travel = [(kb.float(), vb.float(), torch.zeros_like(kb, dtype=torch.float32),
                   torch.zeros_like(vb, dtype=torch.float32))
                  for kb, vb in zip(ring.split(k, 1), ring.split(v, 1))]
        for step in range(ring.size):
            merged = []
            for i, (kb, vb, dk, dv) in enumerate(travel):
                dq_i, dk_i, dv_i = _block_grads(qs[i], kb, vb, douts[i], lses[i], deltas[i],
                                                scale)
                dqs[i] += dq_i
                merged.append((kb, vb, dk + dk_i, dv + dv_i))
            if step + 1 < ring.size:
                travel = ring.rotate(merged)
            else:  # the last rotation takes the accumulators home
                travel = ring.rotate([(dk, dv) for _, _, dk, dv in merged])
        dq = ring.join(dqs, 1)
        dk = ring.join([t[0] for t in travel], 1)
        dv = ring.join([t[1] for t in travel], 1)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Full-sequence softmax attention with K/V rotating around the ranks of
    ``group``: q, k, v are this rank's (n_local, heads, dim_head) blocks,
    block r on the group's rank r; returns this rank's (n_local, heads,
    dim_head) output block, in q's dtype. The result equals dense attention
    over the gathered sequence."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return _RingAttention.apply(q[None], k[None], v[None], _GroupRing(group), scale)[0]


def blockwise_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             n_blocks: int, scale: Optional[float] = None) -> torch.Tensor:
    """``ring_self_attention``'s schedule over ``n_blocks`` blocks of one
    process's (n, heads, dim_head) sequence (n divisible by ``n_blocks``),
    forward and backward: what ``n_blocks`` ranks compute, on one device."""
    if q.shape[0] % n_blocks:
        raise ValueError(f"sequence length {q.shape[0]} must divide into {n_blocks} blocks")
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return _RingAttention.apply(q[None], k[None], v[None], _LocalRing(n_blocks), scale)[0]


def _gather_seq(x: torch.Tensor, group, size: int) -> torch.Tensor:
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=1)


def _own_block(x: torch.Tensor, group, size: int) -> torch.Tensor:
    per = x.shape[1] // size
    me = dist.get_rank(group)
    return x[:, me * per:(me + 1) * per]


class _TakeBlock(torch.autograd.Function):
    """Forward: this rank's block of a whole sequence (dim 1) that every
    rank holds. Backward: the ranks' block gradients gathered whole."""

    @staticmethod
    def forward(ctx, x, group, size: int):
        ctx.group, ctx.size = group, size
        return _own_block(x, group, size)

    @staticmethod
    def backward(ctx, grad):
        return _gather_seq(grad, ctx.group, ctx.size), None, None


class _GatherBlocks(torch.autograd.Function):
    """Forward: the ranks' blocks gathered into the whole sequence (dim 1).
    Backward: this rank's block of the upstream gradient, which every rank
    computes whole and alike."""

    @staticmethod
    def forward(ctx, x, group, size: int):
        ctx.group, ctx.size = group, size
        return _gather_seq(x, group, size)

    @staticmethod
    def backward(ctx, grad):
        return _own_block(grad, ctx.group, ctx.size), None, None


def sequence_parallel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                axis: str = "seq",
                                scale: Optional[float] = None) -> torch.Tensor:
    """Attention over the whole (b, n, h, d) sequence, which every rank of
    the active mesh's ``axis`` holds alike, by the ring over that axis;
    returns the whole (b, n, h, d) output on every rank. Raises
    ``ValueError`` without an active mesh with that axis, or when the
    axis's size does not divide n (JAX's ``_ring_shard_map``)."""
    mesh = current_mesh()
    names = tuple(mesh.mesh_dim_names or ()) if mesh is not None else ()
    if axis not in names:
        raise ValueError(f"backend='ring' needs an active mesh with a {axis!r} axis; "
                         f"got mesh axes {names}")
    n = q.shape[1]
    size = mesh.size(names.index(axis))
    if n % size:
        raise ValueError(f"sequence length {n} must divide the {axis!r} axis ({size})")
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    group = mesh_axis(mesh, axis)[0]
    if size == 1:
        return _RingAttention.apply(q, k, v, _GroupRing(group), scale)
    blocks = [_TakeBlock.apply(x, group, size) for x in (q, k, v)]
    out = _RingAttention.apply(*blocks, _GroupRing(group), scale)
    return _GatherBlocks.apply(out, group, size)


def dense_reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Plain softmax attention over whole (n, h, d) tensors, fp32 scores and
    products, the result in q's dtype (the test oracle)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum("qhd,khd->hqk", q.float(), k.float()) * scale
    out = torch.einsum("hqk,khd->hqd", torch.softmax(s, dim=-1), v.float())
    return out.transpose(0, 1).to(q.dtype)
