"""The port's HisToGene objects for ``configs/histogene.json``, and the
operations of its slide step.

Builds the program as ``baselines/trainer.py::train_baseline_fold`` runs it
(``build_baseline`` with the config's attention backend, the family's
optimizer, ``make_slide_step``) and loads the benchmark's weights into it.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark import data
from benchmark.harness import load_module

NAME = "histogene"
_ref = load_module("reference", NAME)


def specs(cfg: dict):
    return _ref.parameter_specs(cfg)


def weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return data.make_weights(specs(cfg), seed, device)


def baseline_config(cfg: dict):
    from mclstexp_tpu_torch.baselines.trainer import BaselineConfig

    return BaselineConfig(model="histogene", n_genes=cfg["n_genes"],
                          patch_size=cfg["patch_size"], n_pos=cfg["n_pos"],
                          n_layers=cfg["n_layers"], lr=cfg["lr"],
                          weight_decay=cfg["weight_decay"], bucket=cfg["bucket"],
                          dtype=cfg["dtype"])


def train_state(cfg: dict, state_dict, device):
    from mclstexp_tpu_torch.baselines.trainer import baseline_optimizer, build_baseline
    from mclstexp_tpu_torch.train.state import TrainState

    bcfg = baseline_config(cfg)
    m = build_baseline(bcfg, device, cfg["attn_backend"])
    m.load_state_dict(state_dict, strict=True)
    return TrainState(m, baseline_optimizer(bcfg, m.parameters()))


def train_step(cfg: dict):
    from mclstexp_tpu_torch.baselines.trainer import make_slide_step

    return make_slide_step(baseline_config(cfg))


def slide_batch(rows: Dict[str, torch.Tensor], bucket: int) -> Dict[str, torch.Tensor]:
    """One slide padded to the next multiple of ``bucket`` as the program's
    ``pad_slide`` / ``slide_tensors`` give it: zero rows, mask False on them."""
    n = rows["expression"].shape[0]
    pad = -(-n // bucket) * bucket - n

    def pad0(x):
        return torch.cat([x, x.new_zeros((pad, *x.shape[1:]))]) if pad else x

    return {"patches": pad0(rows["image_u8"]), "positions": pad0(rows["position"].int()),
            "expression": pad0(rows["expression"]),
            "mask": torch.cat([torch.ones(n, dtype=torch.bool, device=rows["expression"].device),
                               torch.zeros(pad, dtype=torch.bool,
                                           device=rows["expression"].device)])}


def slide_flops(cfg: dict, n: int) -> float:
    """Operations of one slide step on ``n`` real spots (padded rows are not
    counted): forward and backward, the backward twice the forward except
    the patch embedding's, whose input needs no gradient (once)."""
    dim, mlp = cfg["dim"], cfg["mlp_dim"]
    inner = cfg["heads"] * cfg["dim_head"]
    embed = 2 * n * 3 * cfg["patch_size"] ** 2 * dim
    layer = 2 * n * dim * 3 * inner + 4 * n * n * inner + 2 * n * inner * dim + 4 * n * dim * mlp
    head = 2 * n * dim * cfg["n_genes"]
    return 3.0 * (embed + cfg["n_layers"] * layer + head) - embed


def attention_calls(cfg: dict, n: int):
    """The step's flash-attention training calls: (count, (b, h, n_pad, d), real rows)."""
    n_pad = -(-n // cfg["bucket"]) * cfg["bucket"]
    return cfg["n_layers"], (1, cfg["heads"], n_pad, cfg["dim_head"]), n
