"""Core transformer layers of the spot tower and the projection heads.

Port of ``mclstexp_tpu/core/layers.py``. The modules carry the reference
torch attribute names (the keys ``models/image/torch_export.py`` writes), so
a reference-layout ``state_dict`` loads into them with ``strict=True``:

* ``AttnBlock``: ``attn.norm``, ``attn.fn.to_qkv``, ``attn.fn.to_out.0``,
  ``ff.norm``, ``ff.fn.net.0``, ``ff.fn.net.3``;
* ``ProjectionHead``: ``projection``, ``fc``, ``layer_norm``.

Attention takes the JAX module's ``backend``: "xla" is the fused-matmul path
of the JAX build (fp32 softmax, scale ``dim_head**-0.5``, masked keys filled
with -1e30; ``ops.flash_attention.attention_plain``), "flash" the CUDA
flash-attention kernels (``ops.flash_attention``: the forward, and under
autograd the dK/dV and dQ kernels in the backward; a padded sequence's mask
becomes their segment ids; on a CPU tensor the plain versions and the key
mask, as the JAX build falls back off a TPU). "ring" raises: the port has no
device mesh yet.

Initialization reproduces torch defaults as the JAX build does (Linear
U(+-1/sqrt(fan_in)), Embedding N(0, 1)), drawn from an explicit
``torch.Generator`` by ``init_parameters``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mclstexp_tpu_torch.ops.flash_attention import attention_plain, flash_attention

# variance_scaling(2.0, "fan_out", "truncated_normal") of the JAX build:
# the std of a unit normal truncated to [-2, 2].
_TRUNC_STD = 0.87962566103423978


def _trunc_normal_(w: torch.Tensor, std: float, generator: torch.Generator):
    """N(0, std^2) truncated to +-2 std, by the inverse CDF."""
    lo, hi = 0.5 * (1 + math.erf(-2 / math.sqrt(2))), 0.5 * (1 + math.erf(2 / math.sqrt(2)))
    w.uniform_(2 * lo - 1, 2 * hi - 1, generator=generator)
    w.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2 * std, 2 * std)


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter of ``module`` from ``generator``.

    Linear: torch default U(+-1/sqrt(fan_in)) for weight and bias.
    Embedding: N(0, 1). Conv2d: kaiming-normal fan-out, truncated at 2 std
    (the JAX build's conv init). Norm layers: weight 1, bias 0.
    """
    for m in module.modules():
        if isinstance(m, nn.Linear):
            bound = 1.0 / math.sqrt(m.in_features)
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0, generator=generator)
        elif isinstance(m, nn.Conv2d):
            fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
            _trunc_normal_(m.weight, math.sqrt(2.0 / fan_out) / _TRUNC_STD, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return module


def DenseT(in_features: int, out_features: int, bias: bool = True, device=None) -> nn.Linear:
    """Dense layer, fp32 parameters (``nn.Linear``; torch-default init)."""
    return nn.Linear(in_features, out_features, bias=bias, device=device)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def LayerNormT(dim: int, device=None) -> nn.LayerNorm:
    """LayerNorm with torch semantics (eps 1e-5, fp32 statistics)."""
    return nn.LayerNorm(dim, eps=1e-5, device=device)


class MultiHeadSelfAttention(nn.Module):
    """Softmax MHA over a (batch, seq, dim) activation: fused qkv projection
    without bias, per-head scale ``dim_head**-0.5``, output projection
    (present whenever heads != 1 or dim_head != dim).

    backend: "xla" (plain path) or "flash" (the CUDA kernels on a CUDA
    tensor, forward and backward; the plain versions on a CPU one); "ring"
    raises NotImplementedError.
    """

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 dropout: float = 0.0, device=None, backend: str = "xla"):
        super().__init__()
        if backend == "ring":
            raise NotImplementedError(
                "attn_backend='ring' (sequence-parallel attention over a device mesh) is not "
                "ported yet (ROADMAP.md Queue 1, multi-device)")
        if backend not in ("xla", "flash"):
            raise ValueError(f"unknown attention backend {backend!r}; have 'xla', 'flash'")
        self.heads, self.dim_head, self.backend = heads, dim_head, backend
        inner = heads * dim_head
        self.to_qkv = DenseT(dim, inner * 3, bias=False, device=device)
        if heads == 1 and dim_head == dim:
            self.to_out = nn.Identity()
        else:
            self.to_out = nn.Sequential(DenseT(inner, dim, device=device), nn.Dropout(dropout))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, _ = x.shape
        h, d = self.heads, self.dim_head
        qkv = self.to_qkv(x).reshape(b, n, 3, h, d)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (b, h, n, d) views
        attend = flash_attention if self.backend == "flash" else attention_plain
        out = attend(q, k, v, d**-0.5, mask)
        return self.to_out(out.transpose(1, 2).reshape(b, n, h * d))


class FeedForward(nn.Module):
    """GELU MLP: ``net`` = Linear, GELU, Dropout, Linear, Dropout."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0, device=None):
        super().__init__()
        self.net = nn.Sequential(
            DenseT(dim, hidden_dim, device=device),
            nn.GELU(approximate="none"),
            nn.Dropout(dropout),
            DenseT(hidden_dim, dim, device=device),
            nn.Dropout(dropout),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class PreNorm(nn.Module):
    """``fn(LayerNorm(x))`` (the reference's ``PreNorm``; keys ``norm``/``fn``)."""

    def __init__(self, dim: int, fn: nn.Module, device=None):
        super().__init__()
        self.norm = LayerNormT(dim, device=device)
        self.fn = fn

    def forward(self, x: torch.Tensor, *args) -> torch.Tensor:
        return self.fn(self.norm(x), *args)


class AttnBlock(nn.Module):
    """Pre-LN transformer block: x + MHA(LN(x)); x + FF(LN(x))."""

    def __init__(self, dim: int, heads: int, dim_head: int, mlp_dim: int,
                 dropout: float = 0.0, device=None, backend: str = "xla"):
        super().__init__()
        self.attn = PreNorm(
            dim, MultiHeadSelfAttention(dim, heads, dim_head, dropout, device, backend), device
        )
        self.ff = PreNorm(dim, FeedForward(dim, mlp_dim, dropout, device), device)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(x, mask)
        return x + self.ff(x)


class ProjectionHead(nn.Module):
    """Linear -> GELU -> Linear -> Dropout, residual to the first projection,
    then LayerNorm. Shared by both towers."""

    def __init__(self, in_dim: int, projection_dim: int, dropout: float = 0.0, device=None):
        super().__init__()
        self.projection = DenseT(in_dim, projection_dim, device=device)
        self.fc = DenseT(projection_dim, projection_dim, device=device)
        self.dropout = nn.Dropout(dropout)
        self.layer_norm = LayerNormT(projection_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        projected = self.projection(x)
        h = self.dropout(self.fc(gelu_exact(projected)))
        return self.layer_norm(h + projected)


class PositionTables(nn.Module):
    """Learnable (x, y) positional tables indexed by integer coords: two
    N(0, 1) ``nn.Embedding`` tables, summed into the spot features.

    The reference keeps them as top-level ``x_embed``/``y_embed`` of the
    model, so ``MclSTExp`` inherits from this class rather than holding it.
    """

    def __init__(self, vocab: int, dim: int, device=None):
        super().__init__()
        self.x_embed = nn.Embedding(vocab, dim, device=device)
        self.y_embed = nn.Embedding(vocab, dim, device=device)

    def position_embed(self, positions: torch.Tensor) -> torch.Tensor:
        pos = positions.long()
        return self.x_embed(pos[..., 0]) + self.y_embed(pos[..., 1])
