"""Plain PyTorch reference of HisToGene (Pang et al., bioRxiv
2021.11.28.470212; upstream ``vis_model.py::HisToGene`` and its ViT): the
flattened-pixel linear patch embedding, the x/y position tables, the
pre-LN ViT over the slide as one sequence (dropout on the embedding, after
the attention's output projection and twice in each MLP), the LayerNorm /
Linear gene head, the MSE over a slide's spots, and torch Adam.

It runs on the slide's real spots only. The dropout masks are drawn from
the step's generator in the forward's order, each at the padded slide's
shape (1, n_pad, width) and cut to the real rows: keep where U[0, 1) >= p,
kept values scaled by 1 / (1 - p). Imports torch only (and the mclSTExp
reference's shared pieces).
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F

from benchmark.harness import load_module

_base = load_module("reference", "mclstexp-her2st")
adam_steps, linear, attention, layer_norm, precision_mode, compute_dtype, cast = (
    _base.adam_steps, _base.linear, _base.attention, _base.layer_norm, _base.precision_mode,
    _base.compute_dtype, _base.cast)
LAYERS = "vit.transformer.layers."


def parameter_specs(cfg: dict) -> List[tuple]:
    dim, mlp, inner = cfg["dim"], cfg["mlp_dim"], cfg["heads"] * cfg["dim_head"]
    specs = [("x_embed.weight", (cfg["n_pos"], dim), ("normal", 1.0)),
             ("y_embed.weight", (cfg["n_pos"], dim), ("normal", 1.0))]

    def linear_spec(name, cout, cin, bias=True):
        bound = 1.0 / math.sqrt(cin)
        specs.append((f"{name}.weight", (cout, cin), ("uniform", bound)))
        if bias:
            specs.append((f"{name}.bias", (cout,), ("uniform", bound)))

    def ln(name, c):
        specs.extend([(f"{name}.weight", (c,), ("const", 1.0)), (f"{name}.bias", (c,), ("const", 0.0))])

    linear_spec("patch_embedding", dim, 3 * cfg["patch_size"] ** 2)
    for i in range(cfg["n_layers"]):
        pre = f"{LAYERS}{i}."
        ln(pre + "0.norm", dim)
        linear_spec(pre + "0.fn.to_qkv", 3 * inner, dim, bias=False)
        linear_spec(pre + "0.fn.to_out.0", dim, inner)
        ln(pre + "1.norm", dim)
        linear_spec(pre + "1.fn.net.0", mlp, dim)
        linear_spec(pre + "1.fn.net.3", dim, mlp)
    ln("gene_head.0", dim)
    linear_spec("gene_head.1", cfg["n_genes"], dim)
    return specs


def padded(n: int, bucket: int) -> int:
    return -(-n // bucket) * bucket


def forward(P, cfg, patches_u8, position, generator=None, precision="fp32"):
    """(n, G) fp32 predictions of one slide's ``n`` real spots, computed in
    ``precision``'s dtype; dropout from ``generator`` (train mode) or none
    (eval)."""
    n, heads, dh = patches_u8.shape[0], cfg["heads"], cfg["dim_head"]
    n_pad = padded(n, cfg["bucket"])
    dt = compute_dtype(precision)
    P = cast(P, dt)

    def dropout(x):
        if generator is None:
            return x
        keep = torch.rand((1, n_pad, x.shape[-1]), generator=generator,
                          device=x.device)[0, :n]
        return torch.where(keep >= cfg["dropout"], x / (1.0 - cfg["dropout"]),
                           torch.zeros_like(x))

    x = (patches_u8.reshape(n, -1).float() / 255.0).to(dt)
    x = linear(x, P["patch_embedding.weight"], P["patch_embedding.bias"])
    x = dropout(x + P["x_embed.weight"][position[:, 0]] + P["y_embed.weight"][position[:, 1]])
    for i in range(cfg["n_layers"]):
        pre = f"{LAYERS}{i}."
        qkv = linear(layer_norm(P, pre + "0.norm", x), P[pre + "0.fn.to_qkv.weight"])
        q, k, v = qkv.reshape(n, 3, heads, dh).permute(1, 2, 0, 3)
        o = attention(q, k, v).permute(1, 0, 2).reshape(n, heads * dh)
        x = x + dropout(linear(o, P[pre + "0.fn.to_out.0.weight"], P[pre + "0.fn.to_out.0.bias"]))
        h = layer_norm(P, pre + "1.norm", x)
        h = dropout(F.gelu(linear(h, P[pre + "1.fn.net.0.weight"], P[pre + "1.fn.net.0.bias"])))
        x = x + dropout(linear(h, P[pre + "1.fn.net.3.weight"], P[pre + "1.fn.net.3.bias"]))
    x = layer_norm(P, "gene_head.0", x)
    return linear(x, P["gene_head.1.weight"], P["gene_head.1.bias"]).float()


def train_steps(weights, keys, cfg, slides, generators, precision="fp32") -> dict:
    """Adam steps, one slide each: ``slides`` [{"image_u8", "position",
    "expression"} of the real spots], ``generators`` each step's dropout
    generator, seeded as the port's step was."""
    def loss_fn(P, t):
        s = slides[t]
        pred = forward(P, cfg, s["image_u8"], s["position"], generators[t], precision)
        return (pred - s["expression"]).square().mean()

    with precision_mode(precision):
        return adam_steps(weights, keys, cfg, loss_fn, len(slides))
