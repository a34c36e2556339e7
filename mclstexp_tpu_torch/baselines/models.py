"""The slide-level baselines HisToGene and THItoGene, and their shared ViT.

Port of ``mclstexp_tpu/baselines/models.py`` (``SpotViT`` :50-77,
``HisToGene`` :80-110, ``THItoGene`` :218-277). A model takes one whole
section, padded to a bucket with a validity ``mask`` (``trainer.pad_slide``):
patches (N, P, P, 3) float in [0, 1] in the JAX layout (NHWC), array coords
(N, 2), THItoGene also the dense spot adjacency (N, N); it returns (N, G)
expression predictions.

``attn_backend`` is the JAX module's: "xla" (the plain path; masked keys
filled with -1e30) or "flash", the CUDA flash kernels, where the slide's
mask becomes segment ids (real rows see real keys only, padded rows padded
keys only: what the JAX model runs on a TPU); on a CPU tensor "flash" keeps
the key mask, as the JAX model falls back off a TPU. The two agree on real
rows, which are all that reach the loss and the predictions.

``dtype`` "bfloat16" follows the JAX modules' casts: parameters fp32, the
dense layers, convolutions, layer norms and attention in bf16
(``core.layers.set_compute_dtype``), ODConv's four attention heads, the
capsule routing and the GAT's logits in fp32 (where the JAX module's
``nn.Dense`` has no dtype or meets an fp32 parameter), the residual stream
fp32 where the JAX module adds fp32 position tables, and the predictions
returned in fp32.

Attribute names are the reference torch ones (the keys ``mclstexp_tpu/
baselines/torch_import.py:111-131,183-234`` reads): ``patch_embedding``,
``x_embed``/``y_embed``, ``vit.transformer.layers.{i}.{0,1}``,
``gene_head``; THItoGene's ``odconv2d``, ``caps_layer`` and ``gat``.
Hist2ST and BLEEP are not ported yet (ROADMAP.md Queue 1, baselines).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mclstexp_tpu_torch.baselines.layers import (
    EfficientCapsNet,
    GraphAttention,
    MultiHeadGAT,
    ODConv,
    RoutingLayer,
    SeededDropout,
    use_seeded_dropout,
)
from mclstexp_tpu_torch.core.layers import (
    _TRUNC_STD,
    DenseT,
    FeedForward,
    LayerNormT,
    MultiHeadSelfAttention,
    PositionTables,
    PreNorm,
    _trunc_normal_,
    as_compute,
    compute_dtype_of,
    init_parameters,
    set_compute_dtype,
    widen,
)


class SpotViT(nn.Module):
    """The baselines' slide transformer: embedding dropout, then ``depth``
    pre-LN blocks (``transformer.layers.{i}`` = [PreNorm(attention),
    PreNorm(feed-forward)]), dim_head 64, no final LayerNorm. (1, N, dim)
    -> (1, N, dim); ``mask`` (N,) or (1, N) reaches every attention."""

    def __init__(self, dim: int, depth: int, heads: int, mlp_dim: int, dropout: float = 0.0,
                 backend: str = "xla", emb_dropout: Optional[float] = None, device=None):
        super().__init__()
        self.dropout = SeededDropout(dropout if emb_dropout is None else emb_dropout)
        self.transformer = nn.Module()
        self.transformer.layers = nn.ModuleList(
            nn.ModuleList([
                PreNorm(dim, MultiHeadSelfAttention(dim, heads, 64, dropout, device, backend),
                        device),
                PreNorm(dim, FeedForward(dim, mlp_dim, dropout, device), device),
            ])
            for _ in range(depth)
        )

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.dropout(x)
        for attn, ff in self.transformer.layers:
            x = x + attn(x, mask)
            x = x + ff(x)
        return x


class HisToGene(PositionTables):
    """Flattened-pixel linear patch embedding + x/y position tables + ViT +
    LayerNorm/Linear gene head (reference ``HisToGene/vis_model.py:144-191``)."""

    def __init__(self, n_genes: int, patch_size: int = 112, dim: int = 1024,
                 n_layers: int = 4, heads: int = 16, n_pos: int = 64, dropout: float = 0.1,
                 dtype: str = "float32", attn_backend: str = "xla", device="cuda"):
        super().__init__(n_pos, dim, device=device)
        self.n_layers = n_layers
        self.patch_embedding = DenseT(3 * patch_size * patch_size, dim, device=device)
        self.vit = SpotViT(dim, n_layers, heads, 2 * dim, dropout, attn_backend, device=device)
        self.gene_head = nn.Sequential(LayerNormT(dim, device=device),
                                       DenseT(dim, n_genes, device=device))
        use_seeded_dropout(self)
        set_compute_dtype(self, compute_dtype_of(dtype))

    def forward(self, patches: torch.Tensor, positions: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        n = patches.shape[0]
        x = self.patch_embedding(patches.reshape(n, -1)) + self.position_embed(positions)
        x = self.vit(x[None], mask)[0]
        return widen(self.gene_head(x))


class THItoGene(PositionTables):
    """ODConv patchify -> Efficient-CapsNet -> [capsules, x, y] tokens -> ViT
    -> multi-head GAT over the spot graph -> gene head (Linear, ReLU,
    LayerNorm, Linear) (reference ``THItoGene/vis_model.py:153-207``). The
    trunk expects 112-px patches (28 x 28 after the 4 x 4 patchify)."""

    compute_dtype = torch.float32  # the patches are cast to it (JAX models.py:242-243)

    def __init__(self, n_genes: int, patch_size: int = 112, dim: int = 1024,
                 n_layers: int = 4, caps: int = 20, route_dim: int = 64,
                 heads: Tuple[int, int] = (16, 8), n_pos: int = 64, dropout: float = 0.2,
                 dtype: str = "float32", attn_backend: str = "xla", device="cuda"):
        super().__init__(n_pos, route_dim, device=device)
        self.n_layers, self.heads, self.patch_size = n_layers, tuple(heads), patch_size
        vit_dim = (caps + 2) * route_dim
        self.odconv2d = ODConv(3, 16, 4, 4, device=device)
        self.caps_layer = EfficientCapsNet(caps, route_dim, device=device)
        self.vit = SpotViT(vit_dim, n_layers, heads[0], 2 * dim, dropout, attn_backend,
                           device=device)
        self.gat = MultiHeadGAT(vit_dim, 1024, 512, heads[1], dropout, 0.01, device=device)
        self.gene_head = nn.Sequential(
            DenseT(512, 1024, device=device), nn.ReLU(), LayerNormT(1024, device=device),
            DenseT(1024, n_genes, device=device))
        use_seeded_dropout(self)
        set_compute_dtype(self, compute_dtype_of(dtype))

    def forward(self, patches: torch.Tensor, positions: torch.Tensor, adj: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        n = patches.shape[0]
        x = F.relu(self.odconv2d(as_compute(patches.permute(0, 3, 1, 2), self.compute_dtype),
                                 mask))
        caps = self.caps_layer(x, mask)  # (N, caps, route_dim)
        pos = positions.long()
        tokens = torch.cat([caps, self.x_embed(pos[:, 0])[:, None],
                            self.y_embed(pos[:, 1])[:, None]], dim=1)
        seq = self.vit(tokens.reshape(1, n, -1), mask)[0]
        return widen(self.gene_head(self.gat(seq, adj, mask)))


@torch.no_grad()
def init_baseline_parameters(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter from ``generator``: ``core.layers.init_parameters``
    for the standard modules (Linear and Embedding torch defaults, convs
    kaiming-normal fan-out truncated at 2 std), and the JAX initializers'
    families for the rest: GAT ``W`` and ``a`` xavier-uniform with gain
    sqrt(2), ODConv candidate kernels and routing ``W`` kaiming-normal
    fan-out (truncated), routing ``b`` zeros."""
    init_parameters(model, generator)
    for m in model.modules():
        if isinstance(m, GraphAttention):
            for w in (m.W, m.a):
                bound = math.sqrt(12.0 / (w.shape[0] + w.shape[1]))
                w.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, ODConv):
            kn, cout, cin, k, _ = m.weight.shape
            _trunc_normal_(m.weight, math.sqrt(2.0 / (kn * cout)) / _TRUNC_STD, generator)
        elif isinstance(m, RoutingLayer):
            caps, in_caps, _, dim = m.W.shape
            _trunc_normal_(m.W, math.sqrt(2.0 / (caps * in_caps * dim)) / _TRUNC_STD, generator)
            m.b.zero_()
    return model
