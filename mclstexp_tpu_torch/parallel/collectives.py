"""Collectives that carry gradients, and the gradient average of the
data-parallel steps.

JAX trains on several devices as one program over a batch sharded on the
mesh's "data" axis: its losses and batch norms see the global batch, and
XLA inserts the collectives and their transposes. The port runs one process
per rank, each with its rows of the global batch, and names those
collectives itself:

* ``gather_rows``: every rank's rows in rank order (JAX's tiled
  ``all_gather``). Its backward all-reduces the upstream gradient and keeps
  this rank's rows (the transpose, ``psum_scatter``). Every rank computes
  the same global loss from the gathered rows, so a rank's rows receive
  the sum of the ranks' equal gradients: N times one process's.
* ``average_gradients``: one all-reduce of every parameter's gradient, then
  a division by N, after the backward. A gradient that came through
  ``gather_rows`` holds N times this rank's share of the one-process
  gradient, so the average is their sum, the one-process gradient; one
  that every rank computed whole (a replicated batch) averages to itself.

``gather_rows`` is an autograd Function of the port's own:
``dist.all_gather`` carries no gradient, and ``torch.distributed.nn.
functional`` warns on every call that it is deprecated. The batch norms'
collectives are in ``models.image.common`` (their backward is written out).
"""

from __future__ import annotations

from typing import Iterable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rank, ctx.rows = dist.get_rank(group), x.shape[0]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """(N * b, ...) from each rank's (b, ...) along dim 0, rank order."""
    return _GatherRows.apply(x, group)


def average_gradients(params: Iterable[torch.nn.Parameter], group) -> None:
    """Replace each parameter's gradient by its mean over the ranks of
    ``group``: one flat all-reduce, so every rank holds the same bits; the
    new gradients are views into the flat buffer (no copy back). A
    tensor-parallel parameter's gradient (a DTensor, ``parallel.tp``)
    contributes its local shard, which the ranks of ``group`` (the "data"
    axis) hold for the same part of the parameter."""
    params = [p for p in params if p.grad is not None]
    if not params:
        return
    local = [p.grad.to_local() if isinstance(p.grad, DTensor) else p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in local])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    offset = 0
    for p, part in zip(params, local):
        view = flat[offset:offset + part.numel()].view_as(part)
        offset += part.numel()
        g = p.grad
        p.grad = view if not isinstance(g, DTensor) else DTensor.from_local(
            view, g.device_mesh, g.placements, run_check=False, shape=g.shape,
            stride=g.stride())
