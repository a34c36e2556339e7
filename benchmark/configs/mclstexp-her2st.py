"""The port's mclSTExp objects for ``configs/mclstexp-her2st.json``, and the
operations of its train step.

Builds the program as its users run it (``models.mclstexp.MclSTExp``,
``train.state.torch_adam``, ``train.step.make_train_step``,
``infer.serve.PredictionService``) and loads the benchmark's weights into
it; nothing else of the program is called here.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from benchmark import data
from benchmark.harness import load_module

NAME = "mclstexp-her2st"
_ref = load_module("reference", NAME)


def specs(cfg: dict):
    return _ref.parameter_specs(cfg)


def weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return data.make_weights(specs(cfg), seed, device)


def model_config(cfg: dict):
    from mclstexp_tpu_torch.config import ModelConfig

    return ModelConfig(
        encoder_name=cfg["encoder_name"], image_dim=cfg["image_dim"], spot_dim=cfg["spot_dim"],
        projection_dim=cfg["projection_dim"], heads_num=cfg["heads_num"],
        heads_dim=cfg["heads_dim"], head_layers=cfg["head_layers"], dropout=cfg["dropout"],
        temperature=cfg["temperature"], pos_vocab=cfg["pos_vocab"], dtype=cfg["dtype"],
        attn_backend=cfg["attn_backend"])


def model(cfg: dict, state_dict, device):
    from mclstexp_tpu_torch.models.mclstexp import MclSTExp

    m = MclSTExp(model_config(cfg), device=device)
    m.load_state_dict(state_dict, strict=True)
    return m


def train_state(cfg: dict, state_dict, device):
    """The program's train state (model and Adam) holding ``state_dict``."""
    from mclstexp_tpu_torch.train.state import TrainState, torch_adam

    m = model(cfg, state_dict, device)
    return TrainState(m, torch_adam(m.parameters(), cfg["lr"], cfg["weight_decay"]))


def train_step(cfg: dict):
    from mclstexp_tpu_torch.train.step import make_train_step

    return make_train_step("st", rot_impl=cfg["rot_impl"])


def draws(cfg: dict, n: int, generator: torch.Generator, device) -> Tuple[object, dict]:
    """One batch's "st" augmentation draws: factors U(0.5, 1.5), a uniform
    order of the three jitters, a fair-coin flip, an angle U(-180, 180), as
    the program's type and as the reference's dict of the same tensors."""
    from mclstexp_tpu_torch.ops.augment import StDraws

    raw = {"jitter": torch.rand((n, 3), generator=generator, device=device) + 0.5,
           "order": torch.randint(0, 6, (n,), generator=generator, device=device),
           "hflip": torch.rand((n,), generator=generator, device=device) < 0.5,
           "angles": torch.rand((n,), generator=generator, device=device) * 360.0 - 180.0}
    return StDraws(**raw), raw


def batch_of(rows: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: rows[k] for k in ("image_u8", "expression", "position")}


def service(cfg: dict, m, sections, device):
    """The program's prediction service over ``sections`` (the database is
    built by the service itself: the spot tower's B=32 sweep)."""
    from mclstexp_tpu_torch.infer.serve import PredictionService

    return PredictionService.from_sections(
        m, sections, batch_size=cfg["eval_batch_size"], top_k=cfg["top_k"],
        weight_ord=cfg["weight_ord"], max_batch=cfg["max_batch"],
        patch_size=cfg["patch_size"], device=device)


def on_service_thread(service, fn):
    """Queue ``fn`` on the service's own device thread, behind the requests
    already waiting there (a profiler started there sees that thread's
    ranges); returns its future."""
    return service._worker.submit(fn)


def sections(expression: np.ndarray, position: np.ndarray, sizes):
    """Spot-side ``Section``s (no patches, no counts) of the database."""
    from mclstexp_tpu_torch.data.section import Section

    out = []
    for i, (start, n) in enumerate(zip(data.offsets(sizes), sizes)):
        pos = position[start:start + n].astype(np.int32)
        out.append(Section(f"S{i + 1}", expression[start:start + n], pos, pos))
    return out


# ---- operations ---------------------------------------------------------

def tower_flops(cfg: dict) -> Tuple[float, float]:
    """(forward flops of one image through the DenseNet's convolutions, of
    that the stem convolution's): 2 x multiply-adds, norms, ReLUs and
    pools not counted."""
    size = cfg["patch_size"]
    growth, width = cfg["growth_rate"], cfg["bn_size"] * cfg["growth_rate"]
    c = cfg["init_features"]
    hw = (size // 2) ** 2
    stem = 2 * hw * c * 3 * 49
    total = stem
    hw = (size // 4) ** 2
    blocks = cfg["block_config"]
    for bi, layers in enumerate(blocks):
        for li in range(layers):
            total += 2 * hw * (c + li * growth) * width + 2 * hw * width * 9 * growth
        c += layers * growth
        if bi != len(blocks) - 1:
            total += 2 * hw * c * (c // 2)
            c //= 2
            hw //= 4
    return float(total), float(stem)


def train_flops(cfg: dict, b: int) -> float:
    """Operations of one train step on ``b`` rows: forward and backward of
    both towers, the heads and the loss; the backward twice the forward
    except the stem's, whose input needs no gradient (once)."""
    tower, stem = tower_flops(cfg)
    g, p = cfg["spot_dim"], cfg["projection_dim"]
    inner = cfg["heads_num"] * cfg["heads_dim"]
    spot = cfg["head_layers"] * (2 * b * g * 3 * inner + 4 * b * b * inner
                                 + 2 * b * inner * g + 4 * b * g * g)
    heads = 2 * b * (cfg["image_dim"] * p + p * p) + 2 * b * (g * p + p * p)
    loss = 2 * b * b * p
    forward = b * tower + spot + heads + loss
    return 3.0 * forward - b * stem
