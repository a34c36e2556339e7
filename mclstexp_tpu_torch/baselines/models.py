"""The baseline families and the slide baselines' shared ViT.

Port of ``mclstexp_tpu/baselines/models.py`` (``SpotViT`` :50-77,
``HisToGene`` :80-110, ``Hist2ST`` :113-215, ``THItoGene`` :218-277,
``BLEEP`` :280-309). A slide model takes one whole section, padded to a
bucket with a validity ``mask`` (``trainer.pad_slide``): patches (N, P, P,
3) float in [0, 1] in the JAX layout (NHWC), array coords (N, 2), Hist2ST
and THItoGene also the dense spot adjacency (N, N); HisToGene and THItoGene
return (N, G) expression predictions, Hist2ST (predictions, its ZINB or NB
heads or None, h). BLEEP takes a spot batch and returns the two projected
embeddings.

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
fp32 where the JAX module adds fp32 position tables, Hist2ST's neighbour
mean and jump-knowledge LSTM in fp32 (an fp32 adjacency, and flax's
``OptimizedLSTMCell`` without a dtype, promote their bf16 inputs), and the
predictions and embeddings returned in fp32.

Attribute names are the reference torch ones (the keys ``mclstexp_tpu/
baselines/torch_import.py:111-293`` reads): ``patch_embedding``,
``x_embed``/``y_embed``, ``vit.transformer.layers.{i}.{0,1}``,
``gene_head``; Hist2ST's ``vit.transformer.{layer1,down,layer2,layer3,
jknet}`` and heads; THItoGene's ``odconv2d``, ``caps_layer`` and ``gat``;
BLEEP's ``image_encoder``, ``image_projection`` and ``spot_projection``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from mclstexp_tpu_torch.baselines.layers import (
    ConvMixerBlock,
    EfficientCapsNet,
    GraphAttention,
    GraphSAGEBlock,
    MultiHeadGAT,
    ODConv,
    RoutingLayer,
)
from mclstexp_tpu_torch.baselines.losses import disp_act, mean_act
from mclstexp_tpu_torch.core.layers import (
    _TRUNC_STD,
    AttnBlock,
    Conv2dT,
    DenseT,
    FeedForward,
    LayerNormT,
    MultiHeadSelfAttention,
    PositionTables,
    PreNorm,
    ProjectionHead,
    SeededDropout,
    _trunc_normal_,
    as_compute,
    compute_dtype_of,
    init_parameters,
    lecun_normal_,
    set_compute_dtype,
    use_seeded_dropout,
    widen,
)
from mclstexp_tpu_torch.models.image.registry import build_encoder


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


class Hist2ST(PositionTables):
    """Conv patchify (k x k, stride k) -> dropout on the conv map -> ``depth1``
    ConvMixer blocks -> 1 x 1 ``down`` conv to channel // 8 -> flatten in (c,
    h, w) order -> + position tables -> ``depth2`` pre-LN attention blocks
    (dim_head 64, mlp width dim, no embedding dropout) -> ``depth3``
    GraphSAGE blocks -> the jump-knowledge 2-layer LSTM over their outputs
    (depth is its time axis), averaged over depth = h -> LayerNorm / Linear
    gene head; on h the ZINB heads (``mean``, ``disp``, ``pi``) or the NB
    heads (``hr``, ``hp``); with ``coef_head`` the bake-distillation head
    ``coef`` (Linear, ReLU, Linear(1)), whose output replaces h on ``aug``
    passes (reference ``His2ST/HIST2ST.py:85-199``). dim = (fig_size //
    patch_size)^2 * channel // 8: 1,024 at the defaults, 16 heads of 64.
    The LSTM's ``bias_hh_l{0,1}`` are fixed buffers under their state-dict
    keys: ``named_parameters()`` lists what trains. A torch.profiler trace
    shows each pass's ``convmixer`` (patchify to ``down``), ``graph`` (the
    GraphSAGE blocks) and ``jknet`` (the LSTM and its mean) ranges."""

    def __init__(self, n_genes: int, fig_size: int = 112, patch_size: int = 7,
                 channel: int = 32, kernel_size: int = 5, depth1: int = 2, depth2: int = 8,
                 depth3: int = 4, heads: int = 16, n_pos: int = 64, dropout: float = 0.2,
                 zinb: bool = True, nb: bool = False, coef_head: bool = False,
                 dtype: str = "float32", attn_backend: str = "xla", device="cuda"):
        dim = (fig_size // patch_size) ** 2 * channel // 8
        super().__init__(n_pos, dim, device=device)
        self.dim, self.depth1, self.depth2, self.depth3 = dim, depth1, depth2, depth3
        self.zinb, self.nb, self.coef_head = zinb, nb, coef_head
        self.patch_embedding = Conv2dT(3, channel, patch_size, stride=patch_size, device=device)
        self.vit = nn.Module()
        self.vit.dropout = SeededDropout(dropout)
        t = self.vit.transformer = nn.Module()
        t.layer1 = nn.ModuleList(ConvMixerBlock(channel, kernel_size, device)
                                 for _ in range(depth1))
        t.down = nn.Sequential(Conv2dT(channel, channel // 8, 1, device=device))
        t.layer2 = nn.ModuleList(AttnBlock(dim, heads, 64, dim, dropout, device, attn_backend)
                                 for _ in range(depth2))
        t.layer3 = nn.ModuleList(GraphSAGEBlock(dim, dim, device) for _ in range(depth3))
        t.jknet = nn.ModuleList([nn.LSTM(dim, dim, 2, device=device)])
        # flax's cell has one hidden-side bias, torch's bias_ih + bias_hh:
        # bias_hh is a fixed buffer, so training moves their sum as JAX moves
        # its one. nn.LSTM's own setattr keeps its flat weights (cuDNN's) current.
        for layer in range(2):
            name = f"bias_hh_l{layer}"
            fixed = getattr(t.jknet[0], name).detach()
            delattr(t.jknet[0], name)
            t.jknet[0].register_buffer(name, fixed)
            setattr(t.jknet[0], name, fixed)
        self.gene_head = nn.Sequential(LayerNormT(dim, device=device),
                                       DenseT(dim, n_genes, device=device))
        if zinb and nb:
            self.hr = DenseT(dim, n_genes, device=device)
            self.hp = DenseT(dim, n_genes, device=device)
        elif zinb:
            for name in ("mean", "disp", "pi"):
                setattr(self, name, nn.Sequential(DenseT(dim, n_genes, device=device)))
        if coef_head:
            self.coef = nn.Sequential(DenseT(dim, dim, device=device), nn.ReLU(),
                                      DenseT(dim, 1, device=device))
        use_seeded_dropout(self)
        set_compute_dtype(self, compute_dtype_of(dtype))

    def forward(self, patches: torch.Tensor, positions: torch.Tensor, adj: torch.Tensor,
                mask: Optional[torch.Tensor] = None, aug: bool = False):
        n = patches.shape[0]
        t = self.vit.transformer
        with record_function("convmixer"):
            x = self.vit.dropout(self.patch_embedding(patches.permute(0, 3, 1, 2)))
            for block in t.layer1:
                x = block(x, mask)
            x = t.down(x)
        g = (x.reshape(n, -1) + self.position_embed(positions))[None]
        for block in t.layer2:
            g = block(g, mask)
        g, jk = g[0], []
        with record_function("graph"):
            for block in t.layer3:
                g = block(g, adj)
                jk.append(g)
        with record_function("jknet"):  # (depth3, N, dim) -> (N, dim)
            h = t.jknet[0](widen(torch.stack(jk)))[0].mean(dim=0)
        pred = widen(self.gene_head(h))
        extra = None
        if self.zinb and self.nb:
            extra = (widen(self.hr(h)), widen(self.hp(h)))
        elif self.zinb:
            extra = (mean_act(widen(self.mean(h))), disp_act(widen(self.disp(h))),
                     torch.sigmoid(widen(self.pi(h))))
        if self.coef_head and aug:
            return pred, extra, widen(self.coef(h))
        return pred, extra, h


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


class BLEEP(nn.Module):
    """CLIP model: an image tower (``models/image/registry.build_encoder``)
    and two projection heads, one on the tower's features, one on the raw
    expression (no spot encoder) (reference ``Bleep/models.py:9-43``).
    Takes {"image": (B, P, P, 3) float, "expression": (B, G)} and returns
    the fp32 (image_emb, spot_emb); the loss is ``losses.bleep_clip_loss``."""

    def __init__(self, spot_dim: int, encoder_name: str = "resnet50",
                 projection_dim: int = 256, dropout: float = 0.1, temperature: float = 1.0,
                 dtype: str = "float32", device="cuda"):
        super().__init__()
        self.encoder_name, self.temperature = encoder_name, temperature
        self.image_encoder, feat_dim = build_encoder(encoder_name, device=device)
        self.image_projection = ProjectionHead(feat_dim, projection_dim, dropout, device=device)
        self.spot_projection = ProjectionHead(spot_dim, projection_dim, dropout, device=device)
        use_seeded_dropout(self)
        set_compute_dtype(self, compute_dtype_of(dtype))

    def forward(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        image_emb = self.image_projection(self.image_encoder(batch["image"]))
        return widen(image_emb), widen(self.spot_projection(batch["expression"]))


@torch.no_grad()
def init_baseline_parameters(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter from ``generator``: ``core.layers.init_parameters``
    for the standard modules (Linear and Embedding torch defaults, convs
    kaiming-normal fan-out truncated at 2 std, the towers' own families),
    and the JAX initializers' families for the rest: GAT ``W`` and ``a``
    xavier-uniform with gain sqrt(2), ODConv candidate kernels and routing
    ``W`` kaiming-normal fan-out (truncated), routing ``b`` zeros; Hist2ST's
    convs (``patch_embedding``, the mixers', ``down``) flax ``nn.Conv``'s
    lecun-normal (variance 1 / fan_in, truncated; a depthwise 5 x 5 has
    fan_in 25) with zero biases, GraphSAGE ``weight`` xavier-uniform, the
    LSTM's input kernels lecun-normal, each gate's recurrent kernel
    orthogonal and its biases zero (flax ``OptimizedLSTMCell``)."""
    init_parameters(model, generator)

    def lecun_conv(conv: nn.Conv2d):
        lecun_normal_(conv.weight, conv.weight[0].numel(), generator)
        conv.bias.zero_()

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
        elif isinstance(m, Hist2ST):
            lecun_conv(m.patch_embedding)
            lecun_conv(m.vit.transformer.down[0])
        elif isinstance(m, ConvMixerBlock):
            for conv in (m.dw[0], m.dw[3], m.pw[0]):
                lecun_conv(conv)
        elif isinstance(m, GraphSAGEBlock):
            bound = math.sqrt(6.0 / (m.weight.shape[0] + m.weight.shape[1]))
            m.weight.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, nn.LSTM):
            for layer in range(m.num_layers):
                w_ih = getattr(m, f"weight_ih_l{layer}")
                lecun_normal_(w_ih, w_ih.shape[1], generator)
                for gate in getattr(m, f"weight_hh_l{layer}").chunk(4):
                    nn.init.orthogonal_(gate, generator=generator)
                getattr(m, f"bias_ih_l{layer}").zero_()
                getattr(m, f"bias_hh_l{layer}").zero_()
    return model
