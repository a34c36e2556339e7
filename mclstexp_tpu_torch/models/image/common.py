"""Shared building blocks for the image towers (NCHW inside the port).

Port of ``mclstexp_tpu/models/image/common.py``. The JAX build needs its own
``BatchNormT`` to store the UNBIASED batch variance in the running stats
while normalizing with the biased one; that is exactly what torch's
``BatchNorm2d`` does, and its momentum 0.1 is the JAX build's EMA 0.9. The
image towers use it as it is, with one addition: in a data-parallel step
(``global_batch_stats``) the statistics span every rank's rows, as they
span the whole batch under JAX's sharded step. ``MaskedBatchNormT`` is the
JAX module with its ``mask`` argument, which the slide baselines pass
(padded slides).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch
import torch.distributed as dist
from torch import nn

from mclstexp_tpu_torch.core.layers import as_compute, widen


class _GlobalBatchNorm(torch.autograd.Function):
    """A batch norm's train-mode forward and backward over the rows of
    every rank of ``group``, each rank holding an equal share of one
    global batch (NCHW, channels on dim 1).

    Forward: each rank's per-channel mean and biased variance
    (``torch.var_mean``, one pass), all-gathered and combined into the
    global ones (Chan's formula for equal counts: the mean of the means,
    the mean of the variances plus the variance of the means: no
    cancellation of large squares), then (x - mean) * weight * inv + bias.
    Backward: the two per-channel
    gradient sums, sum(dy) and sum(dy * x_hat), from the fused
    ``native_batch_norm_backward`` (they are also the rank's share of the
    bias and weight gradients), all-reduced over the ranks, and
    dx = weight * inv * (dy - mean(dy) - x_hat * mean(dy * x_hat)) with the
    global means: the one-process norm's gradient on the global batch."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        world = dist.get_world_size(group)
        wide = x.to(torch.promote_types(x.dtype, torch.float32))  # bf16 statistics in fp32
        var_mean = torch.stack(torch.var_mean(wide, dim=(0, 2, 3), correction=0))
        parts = [torch.empty_like(var_mean) for _ in range(world)]
        dist.all_gather(parts, var_mean, group=group)
        ranks = torch.stack(parts)  # (world, [var, mean], C)
        mean = ranks[:, 1].mean(dim=0)
        var = ranks[:, 0].mean(dim=0) + (ranks[:, 1] - mean).square().mean(dim=0)
        inv = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, weight, mean, inv)
        ctx.eps, ctx.group = eps, group
        ctx.count = x.numel() // x.shape[1] * world
        ctx.mark_non_differentiable(mean, var)
        # (x - mean) first, as the training-mode kernels take it: a channel
        # far from zero against its spread loses its digits to a fused
        # x * scale + shift (the inference kernels' form). In-place after the
        # subtraction, so that y keeps x's memory format (channels-last in
        # the towers, which take NHWC images).
        shape = (1, -1, 1, 1)
        y = (x - mean.view(shape)).mul_((weight.to(inv.dtype) * inv).view(shape))
        return y.add_(bias.to(inv.dtype).view(shape)).to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, inv = ctx.saved_tensors
        _, dweight, dbias = torch.ops.aten.native_batch_norm_backward(
            dy, x, weight, None, None, mean, inv, True, ctx.eps, [False, True, True])
        sums = torch.stack([dbias, dweight]).to(inv.dtype)
        dist.all_reduce(sums, group=ctx.group)
        m1, m2 = sums / ctx.count
        k = weight.to(inv.dtype) * inv
        shape = (1, -1, 1, 1)
        # dx = k * (dy - m1 - (x - mean) * inv * m2); x - mean first, before
        # any product: x may sit far from zero against its spread; in place
        # after the first pass, in x's memory format
        xm = (x - mean.view(shape)).mul_((k * inv * m2).view(shape))
        dx = (dy * k.view(shape)).sub_((k * m1).view(shape)).sub_(xm)
        return dx.to(x.dtype), dweight, dbias, None, None


class BatchNormT(nn.BatchNorm2d):
    """BatchNorm with torch running-stat semantics (eps 1e-5, momentum 0.1).

    ``group`` (set by ``global_batch_stats``) makes a train-mode forward
    take its statistics over the rows of every rank of that process group,
    each rank holding an equal share of one global batch
    (``_GlobalBatchNorm``: one all-gather of the statistics forward, one
    all-reduce of the two gradient sums backward); the running variance
    unbiased by the global count, as the one-process norm stores it. Its
    forward and backward are the one-process norm's on the global batch.
    Without a group (and at eval) it is ``nn.BatchNorm2d``."""

    group = None

    def __init__(self, channels: int, device=None):
        super().__init__(channels, eps=1e-5, momentum=0.1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.group is None or not self.training:
            return super().forward(x)
        y, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps, self.group)
        n = x.numel() // x.shape[1] * dist.get_world_size(self.group)
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * n / (n - 1) * var)
            self.num_batches_tracked += 1
        return y


@contextlib.contextmanager
def global_batch_stats(module: nn.Module, group) -> Iterator[None]:
    """Within the block every ``BatchNormT`` under ``module`` takes its
    train-mode statistics over the ranks of ``group``."""
    norms = [m for m in module.modules() if isinstance(m, BatchNormT)]
    for m in norms:
        m.group = group
    try:
        yield
    finally:
        for m in norms:
            m.group = None


class MaskedBatchNormT(nn.Module):
    """The JAX ``BatchNormT`` (``models/image/common.py:25-93``) with its
    ``mask``: channels on dim 1 of (B, C, ...) inputs; in train mode the
    statistics are taken over the samples (leading axis) that ``mask``
    marks, all of them without one, as a two-pass variance; the running
    stats move by the 0.9 EMA toward the mean and the UNBIASED variance (n /
    (n - 1), n the count of reduced elements). Masking the padded samples
    out makes a padded slide's train-mode forward equal the unpadded one on
    every real row. At eval the running stats serve and the mask is a no-op.
    eps 1e-5. Keys as ``BatchNorm2d``'s (``weight``, ``bias``,
    ``running_mean``, ``running_var``, ``num_batches_tracked``). Statistics
    and the running update are fp32 for any input; the result is in
    ``compute_dtype``."""

    compute_dtype = torch.float32

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.momentum, self.eps = 0.9, 1e-5
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("running_mean", torch.zeros(channels, device=device))
        self.register_buffer("running_var", torch.ones(channels, device=device))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long, device=device))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = widen(x)
        shape = (1, -1) + (1,) * (x.ndim - 2)  # per channel, broadcast over (B, C, ...)
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            axes = (0,) + tuple(range(2, x.ndim))
            if mask is None:
                n = x.numel() // x.shape[1]
                mean = x.mean(axes)
                var = (x - mean.view(shape)).square().mean(axes)
            else:
                w = mask.to(x.dtype).view((-1,) + (1,) * (x.ndim - 1))
                n = torch.clamp(w.sum() * (x[0].numel() // x.shape[1]), min=1.0)
                mean = (x * w).sum(axes) / n
                var = ((x - mean.view(shape)).square() * w).sum(axes) / n
            with torch.no_grad():
                unbiased = var * (n / max(n - 1, 1) if mask is None
                                  else n / torch.clamp(n - 1, min=1.0))
                self.running_mean.mul_(self.momentum).add_((1.0 - self.momentum) * mean)
                self.running_var.mul_(self.momentum).add_((1.0 - self.momentum) * unbiased)
                self.num_batches_tracked += 1
        inv = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean.view(shape)) * inv.view(shape) + self.bias.view(shape)
        return as_compute(y, self.compute_dtype)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Adaptive average pool to (1, 1) then flatten: (B, C, H, W) -> (B, C)."""
    return x.mean(dim=(2, 3))


def max_pool_3x3_s2() -> nn.MaxPool2d:
    """torch MaxPool2d(3, stride=2, padding=1), the stem's pool."""
    return nn.MaxPool2d(3, stride=2, padding=1)
