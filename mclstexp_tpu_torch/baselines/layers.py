"""Building blocks of the slide-level baselines (NCHW inside the port).

Port of ``mclstexp_tpu/baselines/layers.py``:
  * ``ConvMixerBlock`` (JAX :39-71; reference ``baselines/His2ST/
    HIST2ST.py:14-33``): Hist2ST's depthwise-conv mixer;
  * ``GraphSAGEBlock`` (JAX :74-96; ``baselines/His2ST/gcn.py:12-53``):
    Hist2ST's dense-adjacency GraphSAGE layer, mean aggregation, a Linear
    without bias, ReLU and L2-normalized rows;
  * ``ODConv``: omni-dimensional dynamic convolution in its stride ==
    kernel (patchify) form (JAX :168-233; reference ``baselines/THItoGene/
    ODConv.py:86-141``): four attentions from the pooled input weigh the
    candidate kernels into one kernel per sample, contracted with the
    non-overlapping patches in one batched product;
  * ``squash``, ``RoutingLayer``, ``EfficientCapsNet`` (JAX :236-296;
    ``efficient_capsnet.py:6-92``);
  * ``GraphAttention``, ``MultiHeadGAT`` (JAX :99-165; ``GATLayer.py:6-61``).

Attribute names are the reference torch ones (what ``mclstexp_tpu/
baselines/torch_import.py:139-234`` reads), so a reference checkpoint loads
with ``strict=True``. Batch norms take the slide's ``mask``
(``MaskedBatchNormT``). Dropout is ``core.layers.SeededDropout``: it draws
from a ``torch.Generator`` that the train step sets (``seed_dropout``), so
a step keyed by (seed, epoch, slide) draws the same masks wherever it runs.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mclstexp_tpu_torch.core.layers import Conv2dT, SeededDropout, as_compute, gelu_exact, widen
from mclstexp_tpu_torch.models.image.common import MaskedBatchNormT
from mclstexp_tpu_torch.ops.linear import linear


class ConvMixerBlock(nn.Module):
    """Two depthwise k x k SAME convs, each followed by a masked batch norm
    and exact GELU (``dw`` = [conv, BN, GELU, conv, BN, GELU]), the residual,
    then a 1 x 1 conv, exact GELU and a masked batch norm (``pw`` = [conv,
    GELU, BN]): (N, C, H, W) -> (N, C, H, W). The batch norms take the
    slide's ``mask`` (statistics over real spots) and return
    ``compute_dtype``, as flax's ``BatchNormT(dtype=...)``."""

    def __init__(self, dim: int, kernel_size: int = 5, device=None):
        super().__init__()
        pad = kernel_size // 2
        self.dw = nn.ModuleList([
            Conv2dT(dim, dim, kernel_size, padding=pad, groups=dim, device=device),
            MaskedBatchNormT(dim, device=device), nn.GELU(approximate="none"),
            Conv2dT(dim, dim, kernel_size, padding=pad, groups=dim, device=device),
            MaskedBatchNormT(dim, device=device), nn.GELU(approximate="none"),
        ])
        self.pw = nn.ModuleList([Conv2dT(dim, dim, 1, device=device),
                                 nn.GELU(approximate="none"),
                                 MaskedBatchNormT(dim, device=device)])

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = x
        for i in (0, 3):
            h = gelu_exact(self.dw[i + 1](self.dw[i](h), mask))
        x = gelu_exact(self.pw[0](h + x))
        return self.pw[2](x, mask)


class GraphSAGEBlock(nn.Module):
    """GraphSAGE with gcn=True (Hist2ST's): the neighbours' mean, (adj /
    where(deg == 0, 1, deg)) @ x in fp32 (the JAX module's adjacency is fp32,
    which promotes a bf16 x), a Linear without bias (``weight`` (out, in),
    xavier-uniform) in ``compute_dtype`` (in fp32 ``ops.linear.linear``, as
    ``DenseT``), ReLU, then each row divided by max(its L2 norm, 1e-12)."""

    compute_dtype = torch.float32

    def __init__(self, in_features: int, embed_dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((embed_dim, in_features), device=device))

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        deg = adj.sum(dim=1, keepdim=True)
        neigh = (adj / torch.where(deg == 0, torch.ones_like(deg), deg)) @ widen(x)
        h = F.relu(linear(as_compute(neigh, dt), as_compute(self.weight, dt)))
        norm = torch.sqrt((h * h).sum(dim=1, keepdim=True))
        return h / torch.clamp(norm, min=1e-12)


class GraphAttention(nn.Module):
    """One GAT head over a dense adjacency: e_ij = LeakyReLU(a . [Wh_i,
    Wh_j]); non-neighbours filled with -9e15 and, with a mask, padded
    columns with -1e30 (below every non-neighbour, so an isolated real spot
    averages over real spots only); softmax over j, dropout, then (attn @
    Wh), ELU when ``concat``. Keys ``W`` (in, out), ``a`` (2 out, 1). Wh is
    taken in ``compute_dtype`` (flax's ``nn.Dense(dtype=...)``); the
    logits, softmax and the product with Wh are fp32, as JAX promotes Wh
    against the fp32 ``a`` and attention."""

    compute_dtype = torch.float32

    def __init__(self, in_features: int, out_features: int, dropout: float = 0.2,
                 alpha: float = 0.01, concat: bool = True, device=None):
        super().__init__()
        self.out_features, self.alpha, self.concat = out_features, alpha, concat
        self.W = nn.Parameter(torch.empty((in_features, out_features), device=device))
        self.a = nn.Parameter(torch.empty((2 * out_features, 1), device=device))
        self.dropout = SeededDropout(dropout)

    def forward(self, h: torch.Tensor, adj: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = self.compute_dtype
        wh = widen(as_compute(h, dt) @ as_compute(self.W, dt))
        e1 = wh @ self.a[: self.out_features]
        e2 = wh @ self.a[self.out_features:]
        e = F.leaky_relu(e1 + e2.T, negative_slope=self.alpha)
        e = torch.where(adj > 0, e, torch.full_like(e, -9e15))
        if mask is not None:
            e = torch.where(mask[None, :], e, torch.full_like(e, -1e30))
        attn = self.dropout(torch.softmax(e, dim=1))
        out = attn @ wh
        return F.elu(out) if self.concat else out


class MultiHeadGAT(nn.Module):
    """Dropout, ``heads`` concatenated ELU heads (``attention_{i}``), dropout,
    one output head (``out_att``), ELU."""

    def __init__(self, in_features: int, nhid: int, out_features: int, heads: int = 4,
                 dropout: float = 0.2, alpha: float = 0.01, device=None):
        super().__init__()
        self.heads = heads
        for i in range(heads):
            self.add_module(f"attention_{i}", GraphAttention(in_features, nhid, dropout, alpha,
                                                             True, device))
        self.out_att = GraphAttention(nhid * heads, out_features, dropout, alpha, False, device)
        self.dropout = SeededDropout(dropout)

    def forward(self, x: torch.Tensor, adj: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.dropout(x)
        x = torch.cat([getattr(self, f"attention_{i}")(x, adj, mask) for i in range(self.heads)],
                      dim=1)
        return F.elu(self.out_att(self.dropout(x), adj, mask))


class _ODAttention(nn.Module):
    """ODConv's four attentions from the pooled input: 1x1 convs ``fc`` (no
    bias) -> masked BN -> ReLU, then ``channel_fc``, ``filter_fc``,
    ``spatial_fc`` (sigmoids) and ``kernel_fc`` (softmax over kernels). The
    four heads stay fp32 in a bf16 model (the JAX module's ``nn.Dense``
    without a dtype promotes to its fp32 parameters)."""

    def __init__(self, in_planes: int, out_planes: int, kernel_size: int, kernel_num: int,
                 attn_ch: int, device=None):
        super().__init__()
        self.kernel_size, self.kernel_num = kernel_size, kernel_num
        self.fc = Conv2dT(in_planes, attn_ch, 1, bias=False, device=device)
        self.bn = MaskedBatchNormT(attn_ch, device=device)
        self.channel_fc = nn.Conv2d(attn_ch, in_planes, 1, device=device)
        self.filter_fc = nn.Conv2d(attn_ch, out_planes, 1, device=device)
        self.spatial_fc = nn.Conv2d(attn_ch, kernel_size * kernel_size, 1, device=device)
        self.kernel_fc = nn.Conv2d(attn_ch, kernel_num, 1, device=device)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        b, k = x.shape[0], self.kernel_size
        f = widen(F.relu(self.bn(self.fc(x.mean(dim=(2, 3), keepdim=True)), mask)))
        return (torch.sigmoid(self.channel_fc(f)).view(b, -1),
                torch.sigmoid(self.filter_fc(f)).view(b, -1),
                torch.sigmoid(self.spatial_fc(f)).view(b, k, k),
                torch.softmax(self.kernel_fc(f).view(b, self.kernel_num), dim=-1))


class ODConv(nn.Module):
    """Omni-dimensional dynamic conv, stride == kernel_size (THItoGene's
    patchify): (B, Cin, H, W) -> (B, Cout, H / k, W / k). Per sample the
    kernel is sum_n kernel_attn[n] * weight[n] * spatial_attn, the input is
    scaled by channel_attn, and the output by filter_attn. ``weight`` keeps
    the reference layout (Kn, Cout, Cin, k, k). In bf16, the JAX module's
    types: the aggregate kernel from bf16 operands, scaled in fp32; the
    patch product rounds the patches and its result to bf16."""

    compute_dtype = torch.float32

    def __init__(self, in_planes: int, out_planes: int, kernel_size: int, stride: int,
                 kernel_num: int = 4, reduction: float = 0.0625, min_channel: int = 16,
                 device=None):
        super().__init__()
        if stride != kernel_size:
            raise NotImplementedError("ODConv is ported in its stride == kernel_size form only")
        self.kernel_size = kernel_size
        attn_ch = max(int(in_planes * reduction), min_channel)
        self.attention = _ODAttention(in_planes, out_planes, kernel_size, kernel_num, attn_ch,
                                      device)
        self.weight = nn.Parameter(torch.empty(
            (kernel_num, out_planes, in_planes, kernel_size, kernel_size), device=device))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, cin, h, w = x.shape
        k = self.kernel_size
        channel, filt, spatial, kernel = self.attention(x, mask)
        dt = self.compute_dtype
        agg = torch.einsum("bn,nocij->bocij", as_compute(kernel, dt), as_compute(self.weight, dt))
        agg = agg * spatial[:, None, None]  # fp32
        x = x * channel[:, :, None, None]
        patches = x.reshape(b, cin, h // k, k, w // k, k).permute(0, 2, 4, 1, 3, 5)
        patches = widen(as_compute(patches.reshape(b, (h // k) * (w // k), cin * k * k), dt))
        out = as_compute(torch.bmm(patches, agg.reshape(b, -1, cin * k * k).transpose(1, 2)), dt)
        out = out * filt[:, None, :]
        return out.transpose(1, 2).reshape(b, -1, h // k, w // k)


def squash(x: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Efficient-CapsNet squash over the last axis."""
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return (1.0 - 1.0 / (torch.exp(n) + eps)) * (x / (n + eps))


class RoutingLayer(nn.Module):
    """Self-attention routing: u = u_in W per output capsule, coupling
    softmax(u u^T summed / sqrt(dim)) over the output capsules + b, then the
    squashed weighted sum. Keys ``W`` (caps, in_caps, in_dim, dim), ``b``
    (caps, in_caps, 1)."""

    def __init__(self, num_capsules: int, dim_capsules: int, in_caps: int = 16,
                 in_dim: int = 8, device=None):
        super().__init__()
        self.dim_capsules = dim_capsules
        self.W = nn.Parameter(torch.empty((num_capsules, in_caps, in_dim, dim_capsules),
                                          device=device))
        self.b = nn.Parameter(torch.zeros((num_capsules, in_caps, 1), device=device))

    def forward(self, u_in: torch.Tensor) -> torch.Tensor:
        # fp32, as JAX promotes u_in against the fp32 W
        u = torch.einsum("...ji,kjiz->...kjz", widen(u_in), self.W)  # (B, caps, in_caps, dim)
        c = torch.einsum("...ij,...kj->...i", u, u)[..., None]
        c = c / math.sqrt(self.dim_capsules)
        c = torch.softmax(c, dim=1) + self.b
        return squash((u * c).sum(dim=-2))


class _PrimaryCaps(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.depthwise_conv = Conv2dT(128, 128, 9, groups=128, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return squash(self.depthwise_conv(x).reshape(x.shape[0], 16, 8))


class EfficientCapsNet(nn.Module):
    """Conv trunk (``conv1..4`` with masked ``batch_norm1..4`` and ReLU),
    primary caps (a depthwise 9x9 conv to 16 capsules of 8) and routing
    (``digit_caps``): (B, 16, 28, 28) -> (B, caps, route_dim)."""

    _TRUNK: Tuple[Tuple[int, int, int, int], ...] = (
        (16, 32, 5, 1), (32, 64, 3, 1), (64, 64, 3, 1), (64, 128, 3, 2))

    def __init__(self, rout_capsules: int, route_dim: int, device=None):
        super().__init__()
        for i, (cin, cout, k, stride) in enumerate(self._TRUNK, start=1):
            self.add_module(f"conv{i}", Conv2dT(cin, cout, k, stride=stride, device=device))
            self.add_module(f"batch_norm{i}", MaskedBatchNormT(cout, device=device))
        self.primary_caps = _PrimaryCaps(device)
        self.digit_caps = RoutingLayer(rout_capsules, route_dim, device=device)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for i in range(1, len(self._TRUNK) + 1):
            x = F.relu(getattr(self, f"batch_norm{i}")(getattr(self, f"conv{i}")(x), mask))
        return self.digit_caps(self.primary_caps(x))
