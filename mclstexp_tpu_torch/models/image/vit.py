"""ViT image towers and the test-sized ``TinyCNN``.

Port of ``mclstexp_tpu/models/image/vit.py``. Inputs are NHWC, as for every
tower of the port.

``ViTEncoder`` is timm's ``vit_base_patch32_224`` built with ``global_pool=
"avg"``: a strided-conv patch embed, a CLS token and a position table,
(CLIP towers only) a LayerNorm on the embedded tokens, pre-LN blocks with a
qkv bias and LayerNorm eps 1e-6, then the mean over the patch tokens (the
CLS token excluded) and a final LayerNorm on the pooled vector (timm's
``fc_norm``). The trunk sits at ``model``, as the reference's tower does;
its blocks are the port's ``AttnBlock``, whose keys ``models/image/
torch_export.py`` renames to timm's.

``TinyCNN`` (the synthetic preset's tower) is three stride-2 3x3 convs, each
followed by GroupNorm(8) and ReLU, the spatial mean and a dense head. flax
pads SAME: a stride-2 3x3 conv pads (0, 1) on an even size and (1, 1) on an
odd one, which ``_same_pad`` reproduces (torch's ``padding=1`` would pad
(1, 1) always). flax's GroupNorm has eps 1e-6.

Initialization follows the JAX modules' flax initializers where they are
not torch's: lecun-normal conv and head kernels, zero biases, a zero CLS
token and an N(0, 0.02^2) position table.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mclstexp_tpu_torch.core.layers import (
    AttnBlock,
    Conv2dT,
    DenseT,
    LayerNormT,
    as_compute,
    lecun_normal_,
    widen,
)


class VisionTransformer(nn.Module):
    """The timm trunk: (B, 3, H, W) -> (B, dim) pooled, normalized features."""

    def __init__(self, patch_size: int = 32, dim: int = 768, depth: int = 12, heads: int = 12,
                 mlp_dim: int = 3072, image_size: int = 224, pre_norm: bool = False,
                 device=None):
        super().__init__()
        self.patch_size, self.dim = patch_size, dim
        n = (image_size // patch_size) ** 2
        self.patch_embed = Conv2dT(3, dim, patch_size, stride=patch_size, device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim, device=device))
        self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, dim, device=device))
        self.norm_pre = LayerNormT(dim, device=device, eps=1e-6) if pre_norm else None
        self.blocks = nn.ModuleList(
            AttnBlock(dim, heads, dim // heads, mlp_dim, device=device, qkv_bias=True,
                      ln_eps=1e-6)
            for _ in range(depth)
        )
        self.norm = LayerNormT(dim, device=device, eps=1e-6)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        w = self.patch_embed.weight
        lecun_normal_(w, w[0].numel(), generator)
        self.patch_embed.bias.zero_()
        self.cls_token.zero_()
        self.pos_embed.normal_(0.0, 0.02, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        x = self.patch_embed(x).flatten(2).transpose(1, 2)  # (B, N, D), row-major patches
        cls, pos = self.cls_token.to(x.dtype), self.pos_embed.to(x.dtype)  # as JAX casts them
        x = torch.cat([cls.expand(b, -1, -1), x], dim=1) + pos
        if self.norm_pre is not None:
            x = self.norm_pre(x)
        for block in self.blocks:
            x = block(x)
        return self.norm(x[:, 1:].mean(dim=1))


class ViTEncoder(nn.Module):
    """ViT feature tower: (B, H, W, 3) NHWC -> (B, dim) fp32, computing in
    ``compute_dtype``."""

    compute_dtype = torch.float32

    def __init__(self, device=None, **kw):
        super().__init__()
        self.model = VisionTransformer(device=device, **kw)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return widen(self.model(as_compute(images.permute(0, 3, 1, 2), self.compute_dtype)))


def _same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """flax/XLA "SAME" padding of a (B, C, H, W) input: out = ceil(in /
    stride), the excess padding on the high side."""
    pads = []
    for size in (x.shape[3], x.shape[2]):  # F.pad lists the last dim first
        total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class TinyCNN(nn.Module):
    """Small conv tower for the synthetic preset and CPU tests: (B, H, W, 3)
    NHWC -> (B, features) fp32. In bf16 the group norms take fp32 statistics
    and return bf16, as flax's ``GroupNorm(dtype=...)``."""

    widths = (16, 32, 64)
    compute_dtype = torch.float32

    def __init__(self, features: int = 128, device=None):
        super().__init__()
        c_in = 3
        for i, c in enumerate(self.widths):
            setattr(self, f"conv{i}", Conv2dT(c_in, c, 3, stride=2, device=device))
            setattr(self, f"gn{i}", nn.GroupNorm(8, c, eps=1e-6, device=device))
            c_in = c
        self.head = DenseT(c_in, features, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        for i in range(len(self.widths)):
            conv = getattr(self, f"conv{i}")
            lecun_normal_(conv.weight, conv.weight[0].numel(), generator)
            conv.bias.zero_()
        lecun_normal_(self.head.weight, self.head.in_features, generator)
        self.head.bias.zero_()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = as_compute(images.permute(0, 3, 1, 2), dt)
        for i in range(len(self.widths)):
            x = getattr(self, f"conv{i}")(_same_pad(x, 3, 2))
            x = F.relu(as_compute(getattr(self, f"gn{i}")(widen(x)), dt))
        return widen(self.head(x.mean(dim=(2, 3))))


def vit_b32(device=None) -> ViTEncoder:
    return ViTEncoder(device=device)


def vit_l32(device=None) -> ViTEncoder:
    """ViT-L/32 (timm ``vit_large_patch32_224_in21k``), BLEEP's ViT-L option."""
    return ViTEncoder(dim=1024, depth=24, heads=16, mlp_dim=4096, device=device)


def clip_vit_b32(device=None) -> ViTEncoder:
    """CLIP ViT-B/32 (timm ``vit_base_patch32_224_clip_laion2b``): the ViT-B/32
    trunk with the CLIP pre-norm on the embedded tokens."""
    return ViTEncoder(pre_norm=True, device=device)


def tiny_cnn(device=None) -> TinyCNN:
    return TinyCNN(device=device)
