"""Flax (params, batch_stats) trees -> the port's ``state_dict``.

The input is the JAX build's ``MclSTExp`` variables as nested dicts of
NumPy arrays (``jax.device_get`` of the trees); the output uses the
reference torch keys that ``mclstexp_tpu/models/image/torch_export.py``
writes, and loads into the port's ``MclSTExp`` with ``strict=True``:
  * conv kernels HWIO -> OIHW; dense kernels (in, out) -> (out, in);
  * BatchNorm ``scale``/``bias``/``mean``/``var`` -> ``weight``/``bias``/
    ``running_mean``/``running_var``, plus a zero ``num_batches_tracked``;
  * LayerNorm ``scale``/``bias`` -> ``weight``/``bias``.
Every image tower is covered: the densenet and resnet block layouts and the
ViT depth are read from the tree (so ``tiny_densenet`` too), and
``tiny_cnn``'s convs keep their biases and its GroupNorms map like
LayerNorms. Position tables keep their ``pos_vocab`` rows. Every leaf must
be consumed, or the conversion raises.

``baseline_params_from_jax`` does the same for the four baseline families,
into the reference keys that ``mclstexp_tpu/baselines/torch_import.py``
reads (the inverse of its importers); THItoGene's 1x1-conv Denses become
(out, in, 1, 1) weights and ODConv's candidate kernels go back to (Kn,
Cout, Cin, k, k); Hist2ST's two ``OptimizedLSTMCell``s become one 2-layer
``nn.LSTM`` (gates [i, f, g, o] stacked by rows, the cell's hidden-side
bias in ``bias_ih``, ``bias_hh`` zero: the JAX importer sums the two back);
BLEEP's tower maps like the flagship's.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from mclstexp_tpu_torch.config import ModelConfig
from mclstexp_tpu_torch.models.image.torch_import import RESNETS, VITS


class _Converter:
    def __init__(self, params: Mapping[str, Any], batch_stats: Mapping[str, Any]):
        self.params, self.batch_stats = params, batch_stats
        self.out: Dict[str, torch.Tensor] = {}
        self.consumed = set()

    def get(self, stats: bool, *path: str) -> np.ndarray:
        node = self.batch_stats if stats else self.params
        for p in path:
            node = node[p]
        self.consumed.add((stats, path))
        return np.asarray(node)

    def put(self, key: str, value: np.ndarray):
        self.out[key] = torch.from_numpy(np.array(value, order="C"))  # a writable copy

    def conv(self, key: str, *path: str, bias: bool = False):
        self.put(f"{key}.weight", np.transpose(self.get(False, *path, "kernel"), (3, 2, 0, 1)))
        if bias:
            self.put(f"{key}.bias", self.get(False, *path, "bias"))

    def conv1x1(self, key: str, *path: str, bias: bool = True):
        """A Dense over pooled features -> a 1x1 conv's (out, in, 1, 1)."""
        self.put(f"{key}.weight", self.get(False, *path, "kernel").T[:, :, None, None])
        if bias:
            self.put(f"{key}.bias", self.get(False, *path, "bias"))

    def linear(self, key: str, *path: str, bias: bool = True):
        self.put(f"{key}.weight", self.get(False, *path, "kernel").T)
        if bias:
            self.put(f"{key}.bias", self.get(False, *path, "bias"))

    def ln(self, key: str, *path: str):
        self.put(f"{key}.weight", self.get(False, *path, "scale"))
        self.put(f"{key}.bias", self.get(False, *path, "bias"))

    def bn(self, key: str, *path: str):
        self.ln(key, *path)
        self.put(f"{key}.running_mean", self.get(True, *path, "mean"))
        self.put(f"{key}.running_var", self.get(True, *path, "var"))
        self.out[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)

    def leftovers(self):
        def walk(tree, stats, prefix=()):
            missing = []
            for k, v in tree.items():
                if isinstance(v, Mapping):
                    missing += walk(v, stats, (*prefix, k))
                elif (stats, (*prefix, k)) not in self.consumed:
                    missing.append(".".join((*prefix, k)))
            return missing

        return walk(self.params, False) + walk(self.batch_stats, True)


def _numbered(tree: Mapping[str, Any], stem: str) -> int:
    """How many children ``<stem>1 .. <stem>n`` the tree holds."""
    n = 0
    while f"{stem}{n + 1}" in tree:
        n += 1
    return n


def _densenet(c: _Converter, prefix: str, src: str):
    tree = c.params[src]
    c.conv(f"{prefix}.conv0", src, "conv0")
    c.bn(f"{prefix}.norm0", src, "norm0")
    n_blocks = _numbered(tree, "denseblock")
    for bi in range(1, n_blocks + 1):
        for li in range(1, _numbered(tree[f"denseblock{bi}"], "denselayer") + 1):
            base = f"{prefix}.denseblock{bi}.denselayer{li}"
            d = (src, f"denseblock{bi}", f"denselayer{li}")
            c.bn(f"{base}.norm1", *d, "norm1")
            c.conv(f"{base}.conv1", *d, "conv1")
            c.bn(f"{base}.norm2", *d, "norm2")
            c.conv(f"{base}.conv2", *d, "conv2")
        if bi < n_blocks:
            c.bn(f"{prefix}.transition{bi}.norm", src, f"transition{bi}", "norm")
            c.conv(f"{prefix}.transition{bi}.conv", src, f"transition{bi}", "conv")
    c.bn(f"{prefix}.norm5", src, "norm5")


def _resnet(c: _Converter, prefix: str, src: str):
    """``stem``, ``layer{s}_block{b}/cb{i}`` -> torchvision's Sequential
    numbering (0 conv1, 1 bn1, 4..7 layer1..4)."""
    tree = c.params[src]
    c.conv(f"{prefix}.0", src, "stem", "conv")
    c.bn(f"{prefix}.1", src, "stem", "bn")
    for s in range(4):
        b = 0
        while f"layer{s + 1}_block{b}" in tree:
            name = f"layer{s + 1}_block{b}"
            base = f"{prefix}.{4 + s}.{b}"
            for i in range(1, _numbered(tree[name], "cb") + 1):
                c.conv(f"{base}.conv{i}", src, name, f"cb{i}", "conv")
                c.bn(f"{base}.bn{i}", src, name, f"cb{i}", "bn")
            if "downsample" in tree[name]:
                c.conv(f"{base}.downsample.0", src, name, "downsample", "conv")
                c.bn(f"{base}.downsample.1", src, name, "downsample", "bn")
            b += 1


def _attn_block(c: _Converter, base: str, *src: str, qkv_bias: bool = False):
    """An ``AttnBlock`` (``norm_attn``, ``attn``, ``norm_ff``, ``ff``)."""
    c.ln(f"{base}.attn.norm", *src, "norm_attn")
    c.linear(f"{base}.attn.fn.to_qkv", *src, "attn", "to_qkv", bias=qkv_bias)
    node = c.params
    for p in src:
        node = node[p]
    if "to_out" in node["attn"]:
        c.linear(f"{base}.attn.fn.to_out.0", *src, "attn", "to_out")
    c.ln(f"{base}.ff.norm", *src, "norm_ff")
    c.linear(f"{base}.ff.fn.net.0", *src, "ff", "fc1")
    c.linear(f"{base}.ff.fn.net.3", *src, "ff", "fc2")


def _vit(c: _Converter, prefix: str, src: str):
    tree = c.params[src]
    for name in ("cls_token", "pos_embed"):
        c.put(f"{prefix}.{name}", c.get(False, src, name))
    c.conv(f"{prefix}.patch_embed", src, "patch_embed", bias=True)
    if "norm_pre" in tree:
        c.ln(f"{prefix}.norm_pre", src, "norm_pre")
    for i in range(sum(k.startswith("block") for k in tree)):
        _attn_block(c, f"{prefix}.blocks.{i}", src, f"block{i}", qkv_bias=True)
    c.ln(f"{prefix}.norm", src, "norm")


def _tiny_cnn(c: _Converter, prefix: str, src: str):
    for i in range(sum(k.startswith("conv") for k in c.params[src])):
        c.conv(f"{prefix}.conv{i}", src, f"conv{i}", bias=True)
        c.ln(f"{prefix}.gn{i}", src, f"gn{i}")
    c.linear(f"{prefix}.head", src, "head")


def _tower(c: _Converter, encoder_name: str, tower: str):
    """The image tower's leaves (``image_encoder`` in the JAX tree) -> the
    port's keys under ``tower``."""
    if encoder_name in ("densenet121", "tiny_densenet"):
        _densenet(c, f"{tower}.model.0", "image_encoder")
    elif encoder_name in RESNETS:
        _resnet(c, f"{tower}.model", "image_encoder")
    elif encoder_name in VITS:
        _vit(c, f"{tower}.model", "image_encoder")
    elif encoder_name == "tiny_cnn":
        _tiny_cnn(c, tower, "image_encoder")
    else:
        raise KeyError(f"unknown image encoder {encoder_name!r}")


def _finish(c: _Converter) -> Dict[str, torch.Tensor]:
    leftovers = c.leftovers()
    if leftovers:
        raise ValueError(f"unconverted tree leaves: {leftovers[:8]}")
    return c.out


def tower_params_from_jax(params: Mapping[str, Any], batch_stats: Mapping[str, Any],
                          encoder_name: str) -> Dict[str, torch.Tensor]:
    """Convert the variables of a JAX image tower alone (``TinyCNN``,
    ``ResNetEncoder``, ``ViTEncoder``, ``DenseNetEncoder``) to the
    ``state_dict`` of the port's tower of the same kind."""
    c = _Converter({"image_encoder": params}, {"image_encoder": batch_stats})
    _tower(c, encoder_name, "t")
    return {k[2:]: v for k, v in _finish(c).items()}


def params_from_jax(params: Mapping[str, Any], batch_stats: Mapping[str, Any],
                    model_cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Convert the JAX build's ``MclSTExp`` variables to the port's
    ``state_dict`` (reference key layout)."""
    c = _Converter(params, batch_stats)
    tower = "image_encoder" if model_cfg.variant == "attention" else "image_ecode"
    _tower(c, model_cfg.encoder_name, tower)

    if model_cfg.variant == "attention":
        for i in range(model_cfg.head_layers):
            _attn_block(c, f"spot_encoder.{i}", "spot_encoder", f"block{i}")
        pos = ("spot_encoder", "pos")
    else:
        pos = ("pos",)
    c.put("x_embed.weight", c.get(False, *pos, "x_embed"))
    c.put("y_embed.weight", c.get(False, *pos, "y_embed"))

    _projection_heads(c)
    return _finish(c)


def _projection_heads(c: _Converter):
    for head in ("image_projection", "spot_projection"):
        c.linear(f"{head}.projection", head, "projection")
        c.linear(f"{head}.fc", head, "fc")
        c.ln(f"{head}.layer_norm", head, "layer_norm")


def _slide_vit(c: _Converter, depth: int):
    """The baselines' ViT (``vit.block{i}``) -> ``vit.transformer.layers.{i}``."""
    for i in range(depth):
        base, src = f"vit.transformer.layers.{i}", ("vit", f"block{i}")
        c.ln(f"{base}.0.norm", *src, "norm_attn")
        c.linear(f"{base}.0.fn.to_qkv", *src, "attn", "to_qkv", bias=False)
        c.linear(f"{base}.0.fn.to_out.0", *src, "attn", "to_out")
        c.ln(f"{base}.1.norm", *src, "norm_ff")
        c.linear(f"{base}.1.fn.net.0", *src, "ff", "fc1")
        c.linear(f"{base}.1.fn.net.3", *src, "ff", "fc2")


def baseline_params_from_jax(model, params: Mapping[str, Any],
                             batch_stats: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Convert the JAX build's ``HisToGene``, ``Hist2ST``, ``THItoGene`` or
    ``BLEEP`` variables to the state_dict of the port's ``model`` of the same
    family."""
    from mclstexp_tpu_torch.baselines.models import BLEEP, Hist2ST, HisToGene, THItoGene

    c = _Converter(params, batch_stats)
    if isinstance(model, HisToGene):
        c.linear("patch_embedding", "patch_embedding")
        c.put("x_embed.weight", c.get(False, "pos", "x_embed"))
        c.put("y_embed.weight", c.get(False, "pos", "y_embed"))
        _slide_vit(c, model.n_layers)
        c.ln("gene_head.0", "head_norm")
        c.linear("gene_head.1", "gene_head")
    elif isinstance(model, THItoGene):
        a = "odconv2d.attention"
        c.conv1x1(f"{a}.fc", "odconv", "fc", bias=False)
        c.bn(f"{a}.bn", "odconv", "bn")
        for name in ("channel_fc", "filter_fc", "spatial_fc", "kernel_fc"):
            c.conv1x1(f"{a}.{name}", "odconv", name)
        kn, cout, cin, k, _ = model.odconv2d.weight.shape
        w = c.get(False, "odconv", "weight")  # (Kn, k*k*Cin, Cout), taps (ki, kj, c)
        c.put("odconv2d.weight", w.reshape(kn, k, k, cin, cout).transpose(0, 4, 3, 1, 2))
        for i in range(1, 5):
            c.conv(f"caps_layer.conv{i}", "caps", f"c{i}_conv", bias=True)
            c.bn(f"caps_layer.batch_norm{i}", "caps", f"c{i}_bn")
        c.conv("caps_layer.primary_caps.depthwise_conv", "caps", "primary_dw", bias=True)
        for name in ("W", "b"):
            c.put(f"caps_layer.digit_caps.{name}", c.get(False, "caps", "digit_caps", name))
        c.put("x_embed.weight", c.get(False, "x_embed"))
        c.put("y_embed.weight", c.get(False, "y_embed"))
        _slide_vit(c, model.n_layers)
        for head in [f"attention_{i}" for i in range(model.heads[1])] + ["out_att"]:
            c.put(f"gat.{head}.W", c.get(False, "gat", head, "W", "kernel"))
            c.put(f"gat.{head}.a", c.get(False, "gat", head, "a"))
        c.linear("gene_head.0", "head_fc1")
        c.ln("gene_head.2", "head_norm")
        c.linear("gene_head.3", "head_fc2")
    elif isinstance(model, Hist2ST):
        _hist2st(c, model)
    elif isinstance(model, BLEEP):
        _tower(c, model.encoder_name, "image_encoder")
        _projection_heads(c)
    else:
        raise NotImplementedError(f"{type(model).__name__} is not a ported baseline")
    return _finish(c)


def _lstm_rows(c: _Converter, cell: str, side: str, leaf: str = "kernel") -> np.ndarray:
    """A flax LSTM cell's four gate Denses of one side ("i" input, "h"
    hidden) stacked as torch's rows [i, f, g, o]."""
    return np.concatenate([c.get(False, cell, side + g, leaf).T for g in "ifgo"])


def _hist2st(c: _Converter, model):
    c.conv("patch_embedding", "patch_embedding", bias=True)
    c.put("x_embed.weight", c.get(False, "pos", "x_embed"))
    c.put("y_embed.weight", c.get(False, "pos", "y_embed"))
    t = "vit.transformer"
    for i in range(model.depth1):
        base, src = f"{t}.layer1.{i}", f"mixer{i}"
        for key, unit in (("dw.0", "dw1_conv"), ("dw.3", "dw2_conv"), ("pw.0", "pw_conv")):
            c.conv(f"{base}.{key}", src, unit, bias=True)
        for key, unit in (("dw.1", "dw1_bn"), ("dw.4", "dw2_bn"), ("pw.2", "pw_bn")):
            c.bn(f"{base}.{key}", src, unit)
    c.conv(f"{t}.down.0", "down", bias=True)
    for i in range(model.depth2):
        _attn_block(c, f"{t}.layer2.{i}", "vit", f"block{i}")
    for i in range(model.depth3):
        c.linear(f"{t}.layer3.{i}", f"gs{i}", "weight", bias=False)
    base = f"{t}.jknet.0"
    for layer, cell in enumerate(("jknet_cell", "jknet2_cell")):
        c.put(f"{base}.weight_ih_l{layer}", _lstm_rows(c, cell, "i"))
        c.put(f"{base}.weight_hh_l{layer}", _lstm_rows(c, cell, "h"))
        bias = _lstm_rows(c, cell, "h", "bias")
        c.put(f"{base}.bias_ih_l{layer}", bias)
        c.put(f"{base}.bias_hh_l{layer}", np.zeros_like(bias))
    c.ln("gene_head.0", "head_norm")
    c.linear("gene_head.1", "gene_head")
    if model.zinb and model.nb:
        c.linear("hr", "hr")
        c.linear("hp", "hp")
    elif model.zinb:
        for head in ("mean", "disp", "pi"):
            c.linear(f"{head}.0", head)
    if model.coef_head:
        c.linear("coef.0", "coef_fc1")
        c.linear("coef.2", "coef_fc2")
