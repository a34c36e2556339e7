"""Slide-level training and prediction of the baselines HisToGene and THItoGene.

Port of ``mclstexp_tpu/baselines/trainer.py`` (config, family tables,
``build_baseline``, ``pad_slide``, ``masked_mse``, the slide loss and step,
``init_baseline``, the sequential ``train_baseline_fold``, ``predict_slide``
and ``evaluate_baseline_fold``). The reference trains these families with
Lightning at batch = 1 whole slide; the JAX build, and the port with it,
pads every slide to a ``bucket`` multiple with a mask, which the models
carry through their batch norms (statistics over real spots), attention and
GAT, and the loss: the padded slide's loss and gradients are the unpadded
one's.

One slide per optimizer step, slides in ``np.random.default_rng(seed)``
order per epoch, as in JAX. Dropout draws from a ``torch.Generator``
reseeded per step by (seed, epoch * 1000 + slide index), the keying of the
JAX build's ``fold_in``; torch cannot give JAX's bits, so the tests hold
trajectories at dropout 0 and the dropout by its statistics.

uint8 -> float, two sites that scale differently in JAX: the loss is jitted
there, and XLA multiplies by float32(1 / 255) (``augment.to_float``);
``predict_slide`` divides eagerly, a true division (``to_float_eager``).

Not ported yet (ROADMAP.md Queue 1): Hist2ST and BLEEP (``build_baseline``
raises for them; their options land with them), the slide-DP mode (Queue 1
item 7), ``super_resolution`` and ``torch_import``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from mclstexp_tpu_torch.baselines.graph import knn_adjacency
from mclstexp_tpu_torch.baselines.layers import seed_dropout
from mclstexp_tpu_torch.baselines.models import HisToGene, THItoGene, init_baseline_parameters
from mclstexp_tpu_torch.data.pipeline import split_fold
from mclstexp_tpu_torch.data.section import Section
from mclstexp_tpu_torch.infer.metrics import expression_metrics
from mclstexp_tpu_torch.ops import augment
from mclstexp_tpu_torch.train.state import TrainState, torch_adam
from mclstexp_tpu_torch.utils.logging import MetricLogger
from mclstexp_tpu_torch.utils.meters import AvgMeter


@dataclasses.dataclass(frozen=True)
class BaselineConfig:
    model: str = "histogene"  # histogene | thitogene (hist2st, bleep: not ported yet)
    n_genes: int = 785
    patch_size: int = 112  # all three slide-level baselines use 112px figs
    n_pos: int = 64
    lr: Optional[float] = None  # None -> per-family reference default
    weight_decay: Optional[float] = None  # None -> per-family reference default
    max_epochs: Optional[int] = None  # None -> per-family reference default
    n_layers: Optional[int] = None  # slide-ViT depth; None -> family flow default
    seed: int = 0
    bucket: int = 128  # slide padding granularity
    # THItoGene's spot graph
    knn_k: int = 4
    knn_prune: str = "grid"
    dropout: float = 0.2
    dtype: str = "float32"


# The ported families' reference training protocols (the JAX build's
# tables; their sources are listed at mclstexp_tpu/baselines/trainer.py:75-89).
_FAMILY_LR = {"histogene": 1e-5, "thitogene": 1e-5}
_FAMILY_WD = {"histogene": 0.0, "thitogene": 0.0}
_FAMILY_EPOCHS = {"histogene": 100, "thitogene": 300}
_FAMILY_N_LAYERS = {"histogene": 8, "thitogene": 4}
_USES_ADJ = ("thitogene",)


def resolve_lr(cfg: BaselineConfig) -> float:
    return cfg.lr if cfg.lr is not None else _FAMILY_LR[cfg.model]


def resolve_weight_decay(cfg: BaselineConfig) -> float:
    return cfg.weight_decay if cfg.weight_decay is not None else _FAMILY_WD[cfg.model]


def resolve_epochs(cfg: BaselineConfig) -> int:
    return cfg.max_epochs if cfg.max_epochs is not None else _FAMILY_EPOCHS[cfg.model]


def resolve_n_layers(cfg: BaselineConfig) -> int:
    return cfg.n_layers if cfg.n_layers is not None else _FAMILY_N_LAYERS[cfg.model]


def build_baseline(cfg: BaselineConfig, device="cuda", attn_backend: str = "xla"):
    """The family's model on ``device``, parameters uninitialized (see
    ``init_baseline``). HisToGene's dropout is 0.1 whatever ``cfg.dropout``
    says, as in the JAX build. ``attn_backend`` is not part of the config,
    as in JAX: the caller picks it ("xla" by default)."""
    if cfg.model == "histogene":
        return HisToGene(n_genes=cfg.n_genes, patch_size=cfg.patch_size, n_pos=cfg.n_pos,
                         n_layers=resolve_n_layers(cfg), dropout=0.1, dtype=cfg.dtype,
                         attn_backend=attn_backend, device=device)
    if cfg.model == "thitogene":
        return THItoGene(n_genes=cfg.n_genes, patch_size=cfg.patch_size, n_pos=cfg.n_pos,
                         n_layers=resolve_n_layers(cfg), dropout=cfg.dropout, dtype=cfg.dtype,
                         attn_backend=attn_backend, device=device)
    if cfg.model in ("hist2st", "bleep"):
        raise NotImplementedError(f"baseline {cfg.model!r} is not ported yet (ROADMAP.md "
                                  "Queue 1, baselines)")
    raise KeyError(f"unknown baseline {cfg.model!r}")


def pad_slide(section: Section, bucket: int, with_adj: bool,
              cfg: BaselineConfig) -> Dict[str, np.ndarray]:
    """Pad one section's arrays to the next bucket multiple (zeros; mask
    False on the padded rows); the adjacency over the real spots when
    ``with_adj``."""
    n = section.num_spots
    padded = ((n + bucket - 1) // bucket) * bucket
    pad = padded - n

    def pad0(a, value=0):
        widths = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
        return np.pad(np.asarray(a), widths, constant_values=value)

    out = {
        "patches": pad0(np.asarray(section.patches)),
        "positions": pad0(section.positions),
        "expression": pad0(section.expression),
        "mask": np.concatenate([np.ones(n, bool), np.zeros(pad, bool)]),
    }
    if section.counts is not None:
        out["counts"] = pad0(section.counts)
        sf = section.size_factors
        out["size_factors"] = np.concatenate([sf, np.ones(pad, np.float32)])
    if with_adj:
        adj = knn_adjacency(section.positions, k=cfg.knn_k, prune=cfg.knn_prune)
        full = np.zeros((padded, padded), np.float32)
        full[:n, :n] = adj
        out["adj"] = full
    return out


def slide_tensors(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A ``pad_slide`` dict as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


def masked_mse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    err = (pred - target).square() * mask[:, None]
    return err.sum() / (mask.sum() * pred.shape[1])


def to_float_eager(patches_u8: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 [0, 1] by true division, what eager JAX computes
    (``predict_slide``). The divisor is a tensor on the input's device: a
    Python scalar lets a CUDA division multiply by the reciprocal."""
    return patches_u8.float() / torch.full((), 255.0, device=patches_u8.device)


def _model_args(cfg: BaselineConfig, patches: torch.Tensor, batch) -> tuple:
    args = (patches, batch["positions"])
    return args + (batch["adj"],) if cfg.model in _USES_ADJ else args


def slide_loss(model, cfg: BaselineConfig, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The masked MSE of one padded slide in train mode (the batch norms'
    running stats move, dropout draws from the model's generator)."""
    model.train()
    patches = augment.to_float(batch["patches"])  # the jitted JAX loss's scaling
    pred = model(*_model_args(cfg, patches, batch), mask=batch["mask"])
    return masked_mse(pred, batch["expression"], batch["mask"])


def make_slide_step(cfg: BaselineConfig) -> Callable:
    """The step: (state, padded slide tensors, dropout generator) -> loss,
    one Adam step on the slide's loss; updates the state in place."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: torch.Generator) -> torch.Tensor:
        seed_dropout(state.model, generator)
        loss = slide_loss(state.model, cfg, batch)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return loss.detach()

    return step


def baseline_optimizer(cfg: BaselineConfig, params) -> torch.optim.Optimizer:
    """HisToGene's and THItoGene's reference optimizer: torch Adam (coupled
    L2) at the family's lr and weight decay."""
    return torch_adam(params, resolve_lr(cfg), resolve_weight_decay(cfg))


def init_baseline(cfg: BaselineConfig, device="cuda", attn_backend: str = "xla") -> TrainState:
    """The family's model on ``device``, its parameters drawn from a
    generator seeded with ``cfg.seed``, and a fresh optimizer."""
    device = torch.device(device)
    model = build_baseline(cfg, device, attn_backend)
    init_baseline_parameters(model, torch.Generator(device=device).manual_seed(cfg.seed))
    return TrainState(model, baseline_optimizer(cfg, model.parameters()))


def train_baseline_fold(cfg: BaselineConfig, sections: Sequence[Section], fold: int,
                        logger: Optional[MetricLogger] = None, device="cuda",
                        attn_backend: str = "xla") -> TrainState:
    """Leave-one-out training of a slide-level baseline on ``device``: the
    reference's one slide per optimizer step, every epoch over the training
    sections in ``np.random.default_rng(cfg.seed)`` order. Returns the
    state; one ``MetricLogger`` record per epoch."""
    logger = logger or MetricLogger()
    device = torch.device(device)
    train_secs, _ = split_fold(sections, fold)
    state = init_baseline(cfg, device, attn_backend)
    step = make_slide_step(cfg)
    with_adj = cfg.model in _USES_ADJ
    padded = [slide_tensors(pad_slide(s, cfg.bucket, with_adj, cfg), device) for s in train_secs]
    order_rng = np.random.default_rng(cfg.seed)
    generator = torch.Generator(device=device)
    for epoch in range(resolve_epochs(cfg)):
        meter = AvgMeter("loss")
        for i in order_rng.permutation(len(padded)):
            dropout_rng = augment.reseed(generator, cfg.seed, epoch * 1000 + int(i))
            meter.update(float(step(state, padded[i], dropout_rng)))
        logger.log(model=cfg.model, fold=fold, epoch=epoch, loss=meter.avg)
    return state


@torch.no_grad()
def predict_slide(model, section: Section, cfg: BaselineConfig) -> np.ndarray:
    """(N, G) predictions for one section, in eval mode on the model's
    device."""
    device = next(model.parameters()).device
    batch = slide_tensors(pad_slide(section, cfg.bucket, cfg.model in _USES_ADJ, cfg), device)
    model.eval()
    pred = model(*_model_args(cfg, to_float_eager(batch["patches"]), batch), mask=batch["mask"])
    return pred[: section.num_spots].cpu().numpy()


def evaluate_baseline_fold(cfg: BaselineConfig, sections: Sequence[Section], fold: int,
                           model) -> Dict[str, float]:
    """Per-gene PCC / MSE / MAE of the held-out slide ``sections[fold]``."""
    test = sections[fold]
    return expression_metrics(predict_slide(model, test, cfg), test.expression)
