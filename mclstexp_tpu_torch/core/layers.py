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
mask, as the JAX build falls back off a TPU), "ring" the sequence-parallel
attention over the "seq" axis of the active mesh (``parallel.mesh.
active_mesh``; ``parallel.ring_attention.sequence_parallel_attention``),
with JAX's refusals: no such mesh or an n the axis does not divide raise
``ValueError``, a mask ``NotImplementedError``.

Initialization reproduces torch defaults as the JAX build does (Linear
U(+-1/sqrt(fan_in)), Embedding N(0, 1)), drawn from an explicit
``torch.Generator`` by ``init_parameters``.

Compute dtype (the JAX modules' ``dtype``): parameters stay fp32; each
module that computes (``DenseT``, ``LayerNormT``, ``Conv2dT``, the towers)
has a ``compute_dtype``, fp32 by default, which ``set_compute_dtype`` sets
for a whole model. In bf16 they cast as the flax modules do, explicitly
(no ``torch.autocast``, whose per-op policy rounds at other places):
``DenseT`` and ``Conv2dT`` take a bf16 product of their bf16-cast input
and weight, then add the bias cast to bf16; ``LayerNormT`` takes fp32
statistics and returns bf16; the attention's "xla" path takes fp32 logits
and an fp32 softmax, cast to bf16 before the product with v; "flash" runs
the bf16 kernels. Where a JAX module adds a bf16 and an fp32 array the
result is fp32, and torch promotes the same way. In fp32 every module runs
what it ran before this option existed, on fp32 or (the tests' reference
evaluations) float64 inputs alike: ``as_compute`` and ``widen`` cast only
to and from bf16.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mclstexp_tpu_torch.ops.flash_attention import attention_plain, flash_attention, widen
from mclstexp_tpu_torch.ops.linear import linear
from mclstexp_tpu_torch.parallel.ring_attention import sequence_parallel_attention

# variance_scaling(2.0, "fan_out", "truncated_normal") of the JAX build:
# the std of a unit normal truncated to [-2, 2].
_TRUNC_STD = 0.87962566103423978


def _trunc_normal_(w: torch.Tensor, std: float, generator: torch.Generator):
    """N(0, std^2) truncated to +-2 std, by the inverse CDF."""
    lo, hi = 0.5 * (1 + math.erf(-2 / math.sqrt(2))), 0.5 * (1 + math.erf(2 / math.sqrt(2)))
    w.uniform_(2 * lo - 1, 2 * hi - 1, generator=generator)
    w.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2 * std, 2 * std)


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator):
    """flax's default kernel init: N(0, 1/fan_in) truncated at 2 std."""
    _trunc_normal_(w, math.sqrt(1.0 / fan_in) / _TRUNC_STD, generator)


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter of ``module`` from ``generator``.

    Linear: torch default U(+-1/sqrt(fan_in)) for weight and bias.
    Embedding: N(0, 1). Conv2d: kaiming-normal fan-out, truncated at 2 std
    (the JAX build's conv init). Norm layers: weight 1, bias 0. Then each
    submodule with an ``init_weights(generator)`` method redraws its own
    parameters where the JAX module's initializers differ (flax defaults).
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
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm, nn.GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
    for m in module.modules():
        if hasattr(m, "init_weights"):
            m.init_weights(generator)
    return module


def as_compute(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x in the compute dtype ``dtype``: cast to bf16 in a bf16 model, as it
    is in an fp32 one (which may be a float64 evaluation)."""
    return x if dtype == torch.float32 else x.to(dtype)


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Set ``compute_dtype`` on every submodule of ``module`` that has one;
    the parameters keep their fp32 values and type."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute dtype float32 or bfloat16, got {dtype}")
    for m in module.modules():
        if hasattr(type(m), "compute_dtype"):
            m.compute_dtype = dtype
    return module


def compute_dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a config's ``dtype`` string ("float32" or "bfloat16")."""
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if name not in dtypes:
        raise TypeError(f"dtype must be float32 or bfloat16, got {name!r}")
    return dtypes[name]


class DenseT(nn.Linear):
    """Dense layer: fp32 parameters (torch-default init), the product in
    ``compute_dtype``. In bf16: bf16(x) @ bf16(W)^T, a bf16 result, plus the
    bias cast to bf16 (the JAX ``DenseT``). In fp32: ``ops.linear.linear``,
    the 3xTF32 kernel where its plan picks it on a card, else ``F.linear``."""

    compute_dtype = torch.float32

    def __init__(self, in_features: int, out_features: int, bias: bool = True, device=None):
        super().__init__(in_features, out_features, bias=bias, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == torch.float32:
            return linear(x, self.weight, self.bias)
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


class Conv2dT(nn.Conv2d):
    """``nn.Conv2d`` with fp32 parameters and a ``compute_dtype``, as flax's
    ``nn.Conv(dtype=...)``: in bf16 the bf16-cast input and kernel give a
    bf16 result, then the bias cast to bf16 is added."""

    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == torch.float32:
            return super().forward(x)
        y = self._conv_forward(x.to(dt), self.weight.to(dt), None)
        return y if self.bias is None else y + self.bias.to(dt)[:, None, None]


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


class LayerNormT(nn.LayerNorm):
    """LayerNorm with torch semantics (eps 1e-5 by default): fp32 statistics
    of any input, the result in ``compute_dtype``."""

    compute_dtype = torch.float32

    def __init__(self, dim: int, device=None, eps: float = 1e-5):
        super().__init__(dim, eps=eps, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return as_compute(super().forward(widen(x)), self.compute_dtype)


class MultiHeadSelfAttention(nn.Module):
    """Softmax MHA over a (batch, seq, dim) activation: fused qkv projection
    (without bias in the reference's spot attention, with one in the timm
    ViT towers: ``qkv_bias``), per-head scale ``dim_head**-0.5``, output
    projection (present whenever heads != 1 or dim_head != dim).

    backend: "xla" (plain path), "flash" (the CUDA kernels on a CUDA
    tensor, forward and backward; the plain versions on a CPU one) or
    "ring" (the sequence-parallel path for mega-slides: the sequence is
    split over the active mesh's "seq" axis (JAX's default ``ring_axis``)
    and K/V blocks rotate around its ranks; needs ``parallel.mesh.
    active_mesh`` of a mesh with that axis, whose size divides n; no mask).
    Every rank of the axis gives and gets the whole sequence.
    """

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 dropout: float = 0.0, device=None, backend: str = "xla",
                 qkv_bias: bool = False):
        super().__init__()
        if backend not in ("xla", "flash", "ring"):
            raise ValueError(f"unknown attention backend {backend!r}; have 'xla', 'flash', "
                             f"'ring'")
        self.heads, self.dim_head, self.backend = heads, dim_head, backend
        inner = heads * dim_head
        self.to_qkv = DenseT(dim, inner * 3, bias=qkv_bias, device=device)
        if heads == 1 and dim_head == dim:
            self.to_out = nn.Identity()
        else:
            self.to_out = nn.Sequential(DenseT(inner, dim, device=device), nn.Dropout(dropout))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, _ = x.shape
        h, d = self.heads, self.dim_head
        qkv = self.to_qkv(x).reshape(b, n, 3, h, d)
        if self.backend == "ring":
            if mask is not None:
                raise NotImplementedError("backend='ring' does not support masks; shard the "
                                          "un-padded sequence instead")
            out = sequence_parallel_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], "seq",
                                              d**-0.5)
            return self.to_out(out.reshape(b, n, h * d))
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

    def __init__(self, dim: int, fn: nn.Module, device=None, eps: float = 1e-5):
        super().__init__()
        self.norm = LayerNormT(dim, device=device, eps=eps)
        self.fn = fn

    def forward(self, x: torch.Tensor, *args) -> torch.Tensor:
        return self.fn(self.norm(x), *args)


class AttnBlock(nn.Module):
    """Pre-LN transformer block: x + MHA(LN(x)); x + FF(LN(x)).

    The defaults are the reference's spot blocks; the timm ViT towers take
    ``qkv_bias=True`` and ``ln_eps=1e-6``."""

    def __init__(self, dim: int, heads: int, dim_head: int, mlp_dim: int,
                 dropout: float = 0.0, device=None, backend: str = "xla",
                 qkv_bias: bool = False, ln_eps: float = 1e-5):
        super().__init__()
        self.attn = PreNorm(
            dim, MultiHeadSelfAttention(dim, heads, dim_head, dropout, device, backend,
                                        qkv_bias), device, ln_eps)
        self.ff = PreNorm(dim, FeedForward(dim, mlp_dim, dropout, device), device, ln_eps)

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


class SeededDropout(nn.Module):
    """Dropout of rate ``p`` whose keep mask is drawn from ``self.generator``
    (``seed_dropout``); kept values are scaled by 1 / (1 - p), as flax's
    ``nn.Dropout``. Identity in eval mode or at p = 0; a train-mode call
    without a generator raises.

    ``rows`` = (start, total), set by ``dropout_rows`` in a data-parallel
    step: the input holds rows start.. of a global batch of ``total``, and
    the mask is drawn for the global batch and sliced, so that every rank
    keeps the rows one process would."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)
        self.generator: Optional[torch.Generator] = None
        self.rows: Optional[Tuple[int, int]] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("SeededDropout needs seed_dropout(model, generator) before a "
                               "train-mode forward")
        if self.rows is None:
            keep = torch.rand(x.shape, generator=self.generator, device=x.device)
        else:
            start, total = self.rows
            keep = torch.rand((total,) + tuple(x.shape[1:]), generator=self.generator,
                              device=x.device)[start:start + x.shape[0]]
        return torch.where(keep >= self.p, x / (1.0 - self.p), torch.zeros_like(x))


def use_seeded_dropout(module: nn.Module) -> nn.Module:
    """Replace every ``nn.Dropout`` under ``module`` by a ``SeededDropout``
    of the same rate (neither holds parameters, so the keys stay)."""
    for name, child in module.named_children():
        if isinstance(child, nn.Dropout):
            setattr(module, name, SeededDropout(child.p))
        else:
            use_seeded_dropout(child)
    return module


def seed_dropout(module: nn.Module, generator: torch.Generator) -> None:
    """Let every ``SeededDropout`` under ``module`` draw from ``generator``."""
    for m in module.modules():
        if isinstance(m, SeededDropout):
            m.generator = generator


@contextlib.contextmanager
def dropout_rows(modules: Sequence[nn.Module], start: int, total: int) -> Iterator[None]:
    """Within the block every ``SeededDropout`` under ``modules`` sees rows
    ``start..`` of a global batch of ``total`` rows (``SeededDropout.rows``)."""
    drops = [m for module in modules for m in module.modules()
             if isinstance(m, SeededDropout)]
    for m in drops:
        m.rows = (start, total)
    try:
        yield
    finally:
        for m in drops:
            m.rows = None


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
