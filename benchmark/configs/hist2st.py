"""The port's Hist2ST objects for ``configs/hist2st.json``, and the operations
of its slide step.

Builds the program as ``baselines/trainer.py::train_baseline_fold`` runs it
(``build_baseline("hist2st")`` with the config's attention backend, the
family's Adam, ``make_slide_step`` with one slide an epoch) and loads the
benchmark's weights into it. The model's widths follow from the image's
side (``patch_size``, upstream's ``fig_size``) and the family's defaults;
``train_state`` refuses a config that states others. ``patch`` is
upstream's ``--patch``, the patchify's kernel and stride.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch

from benchmark import data
from benchmark.harness import BENCH, load_json, load_module

NAME = "hist2st"
_ref = load_module("reference", NAME)
# the spot graph's settings (slide_batch is given the rows and the bucket only)
_GRAPH = load_json(BENCH / "configs" / f"{NAME}.json")


def specs(cfg: dict):
    return _ref.parameter_specs(cfg)


def weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return data.make_weights(specs(cfg), seed, device)


def baseline_config(cfg: dict):
    from mclstexp_tpu_torch.baselines.trainer import BaselineConfig

    return BaselineConfig(model=NAME, n_genes=cfg["n_genes"], patch_size=cfg["patch_size"],
                          n_pos=cfg["n_pos"], lr=cfg["lr"], weight_decay=cfg["weight_decay"],
                          bucket=cfg["bucket"], zinb_coef=cfg["zinb"], bake=cfg["bake"],
                          lamb=cfg["lamb"], lr_step_epochs=cfg["lr_step_epochs"],
                          lr_gamma=cfg["lr_gamma"], knn_k=cfg["knn_k"],
                          knn_prune=cfg["knn_prune"], dropout=cfg["dropout"], dtype=cfg["dtype"])


def _widths(model) -> dict:
    t = model.vit.transformer
    attn = t.layer2[0].attn.fn
    return {"patch": model.patch_embedding.kernel_size[0],
            "channel": model.patch_embedding.out_channels,
            "kernel_size": t.layer1[0].dw[0].kernel_size[0], "depth1": len(t.layer1),
            "depth2": len(t.layer2), "depth3": len(t.layer3), "heads": attn.heads,
            "dim_head": attn.dim_head, "dim": model.dim,
            "mlp_dim": t.layer2[0].ff.fn.net[0].out_features}


def train_state(cfg: dict, state_dict, device):
    from mclstexp_tpu_torch.baselines.trainer import baseline_optimizer, build_baseline
    from mclstexp_tpu_torch.train.state import TrainState

    bcfg = baseline_config(cfg)
    m = build_baseline(bcfg, device, cfg["attn_backend"])
    built = _widths(m)
    stated = {k: cfg[k] for k in built}
    if built != stated:
        raise ValueError(f"the program builds Hist2ST at {built}; the config states {stated}")
    m.load_state_dict(state_dict, strict=True)
    return TrainState(m, baseline_optimizer(bcfg, m.parameters()))


def train_step(cfg: dict):
    from mclstexp_tpu_torch.baselines.trainer import make_slide_step

    return make_slide_step(baseline_config(cfg), steps_per_epoch=1)


def slide_batch(rows: Dict[str, torch.Tensor], bucket: int) -> Dict[str, torch.Tensor]:
    """One slide padded to the next multiple of ``bucket`` as the program's
    ``pad_slide`` / ``slide_tensors`` give it: zero rows, mask False on
    them, counts 0 and size factors 1 there, the k-NN adjacency
    (``baselines/graph.knn_adjacency``) over the real spots. The counts and
    size factors are the reference's (``counts_of``), which the reference
    derives again from the same expression."""
    from mclstexp_tpu_torch.baselines.graph import knn_adjacency

    n = rows["expression"].shape[0]
    n_pad = -(-n // bucket) * bucket
    dev = rows["expression"].device

    def pad(x, value=0.0):
        return torch.cat([x, x.new_full((n_pad - n, *x.shape[1:]), value)])

    counts = _ref.counts_of(rows["expression"])
    adj = torch.zeros((n_pad, n_pad), device=dev)
    adj[:n, :n] = torch.from_numpy(knn_adjacency(rows["position"].cpu().numpy(),
                                                 k=_GRAPH["knn_k"], prune=_GRAPH["knn_prune"]))
    graph_edges(n, _GRAPH["knn_k"], _GRAPH["knn_prune"])  # counted here, in set-up
    return {"patches": pad(rows["image_u8"], 0), "positions": pad(rows["position"].int(), 0),
            "expression": pad(rows["expression"]), "counts": pad(counts),
            "size_factors": pad(_ref.size_factors_of(counts), 1.0), "adj": adj,
            "mask": torch.arange(n_pad, device=dev) < n}


@functools.lru_cache(maxsize=None)
def graph_edges(n: int, k: int, prune: str) -> int:
    """Edges of the k-NN graph over ``data.grid(n)``, the layout of every
    slide the benchmark makes."""
    return int(_ref.neighbours(data.grid(n), k, prune)[0].size)


def slide_flops(cfg: dict, n: int) -> float:
    """Operations of one slide step on ``n`` real spots (padded rows are not
    counted): 1 + ``bake`` passes forward and backward, the backward twice
    the forward except where an input needs no gradient (the patchify's
    image, the neighbour mean's adjacency: once). Multiply-adds of the
    convolutions, the linear maps, attention (QK^T and PV), the neighbour
    mean (one per edge and feature) and the LSTM's gates; the coef head on
    the baked passes only."""
    c, dim, g = cfg["channel"], cfg["dim"], cfg["n_genes"]
    inner, mlp = cfg["heads"] * cfg["dim_head"], cfg["mlp_dim"]
    maps = n * (cfg["patch_size"] // cfg["patch"]) ** 2  # output positions of each conv
    patchify = 2 * maps * c * 3 * cfg["patch"] ** 2
    mixer = 2 * maps * c * (2 * cfg["kernel_size"] ** 2 + c)
    down = 2 * maps * c * (c // 8)
    layer = 2 * n * dim * 3 * inner + 4 * n * n * inner + 2 * n * inner * dim + 4 * n * dim * mlp
    mean = 2 * graph_edges(n, cfg["knn_k"], cfg["knn_prune"]) * dim
    sage = 2 * n * dim * dim
    lstm = cfg["depth3"] * 2 * (2 * n * 2 * dim * 4 * dim)  # steps x layers x gates
    heads = 2 * n * dim * g * 4  # gene head and the three ZINB heads
    coef = 2 * n * dim * dim + 2 * n * dim
    forward = (patchify + cfg["depth1"] * mixer + down + cfg["depth2"] * layer
               + cfg["depth3"] * (mean + sage) + lstm + heads)
    once = patchify + cfg["depth3"] * mean
    return (1 + cfg["bake"]) * (3.0 * forward - once) + cfg["bake"] * 3.0 * coef


def attention_calls(cfg: dict, n: int):
    """The step's flash-attention training calls: (count, (b, h, n_pad, d), real rows)."""
    n_pad = -(-n // cfg["bucket"]) * cfg["bucket"]
    return cfg["depth2"] * (1 + cfg["bake"]), (1, cfg["heads"], n_pad, cfg["dim_head"]), n
