"""Training and prediction of the four baseline families.

Port of ``mclstexp_tpu/baselines/trainer.py`` (config, family tables,
``build_baseline``, ``pad_slide``, ``masked_mse``, the bake augmentation,
the slide loss and step, the optimizers, ``init_baseline``, the sequential
``train_baseline_fold``, ``predict_slide``, ``evaluate_baseline_fold``, and
BLEEP's ``make_bleep_step``, ``train_bleep_fold`` and ``bleep_embeddings``).

The slide families (HisToGene, Hist2ST, THItoGene) train with Lightning at
batch = 1 whole slide in the reference; the JAX build, and the port with
it, pads every slide to a ``bucket`` multiple with a mask, which the models
carry through their batch norms (statistics over real spots), attention,
GAT and GraphSAGE, and the losses: the padded slide's loss and gradients
are the unpadded one's. One slide per optimizer step, slides in
``np.random.default_rng(seed)`` order per epoch, as in JAX. Losses:
HisToGene and THItoGene the masked MSE; Hist2ST adds zinb_coef x the
masked ZINB (or NB) of the raw counts and lamb x the self-distillation over
``bake`` augmented passes (reference ``HIST2ST.py:174-199``). BLEEP trains
per spot batch (the shared pipeline's batches) with the soft-target CLIP
loss and AdamW (``Bleep/BLEEP_main.py:60-80``).

Dropout draws from a ``torch.Generator`` reseeded per step by (seed, epoch
* 1000 + slide index), BLEEP's by (seed, epoch * 100000 + batch index), the
keyings of the JAX build's ``fold_in``; torch cannot give JAX's bits, so the
tests hold trajectories at dropout 0 and the dropout by its statistics. For
the same reason Hist2ST's bake draws are an explicit argument
(``BakeDraws``).

uint8 -> float, two sites that scale differently in JAX: the losses are
jitted there, and XLA multiplies by float32(1 / 255) (``augment.to_float``);
``predict_slide`` and ``bleep_embeddings`` divide eagerly, a true division
(``to_float_eager``).

Data parallelism, JAX's two modes:

* slide-DP (``train_baseline_fold(slides_per_step=D, mesh=...)``, JAX's
  ``make_slide_dp_step``): D slides a step, every one padded to the
  training set's largest bucket; the loss and the gradient are the mean
  over the slides and one optimizer step takes the mean gradient; each
  slide's forward takes its own batch statistics from the same old running
  statistics, and the new running statistics are the mean of the slides'
  updates. On one process the D slides run one after another (no group is
  needed, as JAX runs the mode on one device); over a mesh every rank takes
  its share of each step's slides (all of them where the ranks do not
  divide the count) and the gradients, statistics and loss are averaged
  over the ranks (``parallel.collectives.average_gradients``). A scaling
  mode, not the sequential trajectory.
* BLEEP with a ``mesh``: the global batch's objective, as one process's:
  each rank's rows of the batch, global batch norms in the image tower,
  dropout masks drawn for the global batch and sliced, and
  ``bleep_clip_loss_gathered``.

The super-resolution grid and the reference checkpoint import are
``baselines/super_resolution.py`` and ``baselines/torch_import.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from mclstexp_tpu_torch.baselines import losses as bl
from mclstexp_tpu_torch.baselines.graph import knn_adjacency
from mclstexp_tpu_torch.baselines.models import (
    BLEEP,
    Hist2ST,
    HisToGene,
    THItoGene,
    init_baseline_parameters,
)
from mclstexp_tpu_torch.core.layers import dropout_rows, seed_dropout
from mclstexp_tpu_torch.data.pipeline import (
    ConcatSections,
    DeviceResidentData,
    device_train_batches,
    eval_batches,
    split_fold,
)
from mclstexp_tpu_torch.data.section import Section
from mclstexp_tpu_torch.infer.metrics import expression_metrics
from mclstexp_tpu_torch.models.image.common import global_batch_stats
from mclstexp_tpu_torch.ops import augment
from mclstexp_tpu_torch.parallel.collectives import average_gradients
from mclstexp_tpu_torch.parallel.mesh import batch_rows, check_data_mesh, mesh_axis
from mclstexp_tpu_torch.train.state import TrainState, torch_adam
from mclstexp_tpu_torch.train.step import Shard, batch_shard
from mclstexp_tpu_torch.utils.logging import MetricLogger
from mclstexp_tpu_torch.utils.meters import AvgMeter


@dataclasses.dataclass(frozen=True)
class BaselineConfig:
    model: str = "histogene"  # histogene | hist2st | thitogene | bleep
    n_genes: int = 785
    patch_size: int = 112  # all three slide-level baselines use 112px figs
    n_pos: int = 64
    lr: Optional[float] = None  # None -> per-family reference default
    weight_decay: Optional[float] = None  # None -> per-family reference default
    max_epochs: Optional[int] = None  # None -> per-family reference default
    n_layers: Optional[int] = None  # slide-ViT depth; None -> family flow default
    seed: int = 0
    bucket: int = 128  # slide padding granularity
    # Hist2ST extras (reference HIST2ST_train.py defaults: zinb .25, bake 5, lamb .5)
    zinb_coef: float = 0.25
    nb: bool = False
    bake: Optional[int] = None  # augmented distillation passes; None -> family default
    lamb: float = 0.5
    # Hist2ST's StepLR(step_size=50, gamma=0.9), stepped per epoch (HIST2ST.py:237)
    lr_step_epochs: int = 50
    lr_gamma: float = 0.9
    # the spot graph of Hist2ST and THItoGene
    knn_k: int = 4
    knn_prune: str = "grid"
    dropout: float = 0.2
    dtype: str = "float32"
    # BLEEP extras
    batch_size: int = 128
    encoder_name: str = "resnet50"
    temperature: float = 1.0


# The families' reference training protocols (the JAX build's tables;
# their sources are listed at mclstexp_tpu/baselines/trainer.py:75-89).
_FAMILY_LR = {"histogene": 1e-5, "hist2st": 1e-5, "thitogene": 1e-5, "bleep": 1e-3}
_FAMILY_WD = {"histogene": 0.0, "hist2st": 0.0, "thitogene": 0.0, "bleep": 1e-3}
_FAMILY_EPOCHS = {"histogene": 100, "hist2st": 350, "thitogene": 300, "bleep": 4}
_FAMILY_N_LAYERS = {"histogene": 8, "thitogene": 4}
_USES_ADJ = ("hist2st", "thitogene")


def resolve_lr(cfg: BaselineConfig) -> float:
    return cfg.lr if cfg.lr is not None else _FAMILY_LR[cfg.model]


def resolve_weight_decay(cfg: BaselineConfig) -> float:
    return cfg.weight_decay if cfg.weight_decay is not None else _FAMILY_WD[cfg.model]


def resolve_epochs(cfg: BaselineConfig) -> int:
    return cfg.max_epochs if cfg.max_epochs is not None else _FAMILY_EPOCHS[cfg.model]


def resolve_n_layers(cfg: BaselineConfig) -> int:
    return cfg.n_layers if cfg.n_layers is not None else _FAMILY_N_LAYERS[cfg.model]


def resolve_bake(cfg: BaselineConfig) -> int:
    """Hist2ST's bake count (reference default 5, ``HIST2ST_train.py:24``);
    0 for the other families."""
    if cfg.bake is not None:
        return cfg.bake
    return 5 if cfg.model == "hist2st" else 0


def build_baseline(cfg: BaselineConfig, device="cuda", attn_backend: str = "xla"):
    """The family's model on ``device``, parameters uninitialized (see
    ``init_baseline``). HisToGene's dropout is 0.1 whatever ``cfg.dropout``
    says, as in the JAX build. ``attn_backend`` is not part of the config,
    as in JAX: the caller picks it ("xla" by default; BLEEP has no slide
    attention)."""
    if cfg.model == "histogene":
        return HisToGene(n_genes=cfg.n_genes, patch_size=cfg.patch_size, n_pos=cfg.n_pos,
                         n_layers=resolve_n_layers(cfg), dropout=0.1, dtype=cfg.dtype,
                         attn_backend=attn_backend, device=device)
    if cfg.model == "hist2st":
        return Hist2ST(n_genes=cfg.n_genes, fig_size=cfg.patch_size, n_pos=cfg.n_pos,
                       dropout=cfg.dropout, zinb=cfg.zinb_coef > 0, nb=cfg.nb,
                       coef_head=resolve_bake(cfg) > 0, dtype=cfg.dtype,
                       attn_backend=attn_backend, device=device)
    if cfg.model == "thitogene":
        return THItoGene(n_genes=cfg.n_genes, patch_size=cfg.patch_size, n_pos=cfg.n_pos,
                         n_layers=resolve_n_layers(cfg), dropout=cfg.dropout, dtype=cfg.dtype,
                         attn_backend=attn_backend, device=device)
    if cfg.model == "bleep":
        return BLEEP(spot_dim=cfg.n_genes, encoder_name=cfg.encoder_name,
                     temperature=cfg.temperature, dtype=cfg.dtype, device=device)
    raise KeyError(f"unknown baseline {cfg.model!r}")


def pad_slide(section: Section, bucket: int, with_adj: bool,
              cfg: BaselineConfig) -> Dict[str, np.ndarray]:
    """Pad one section's arrays to the next bucket multiple (zeros; mask
    False on the padded rows, size factors 1); the adjacency over the real
    spots when ``with_adj``."""
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
    (``predict_slide``, ``bleep_embeddings``). The divisor is a tensor on
    the input's device: a Python scalar lets a CUDA division multiply by the
    reciprocal."""
    return patches_u8.float() / torch.full((), 255.0, device=patches_u8.device)


@dataclasses.dataclass
class BakeDraws:
    """The random numbers of Hist2ST's bakes: one shared draw per bake for
    the whole slide (reference ``HIST2ST.py:53-57,160-166``)."""

    gray: Tuple[bool, ...]  # RandomGrayscale(0.1)
    angles: torch.Tensor  # (n_bake,) float32 degrees, U(-90, 90): RandomRotation(90)
    flip: Tuple[bool, ...]  # RandomHorizontalFlip(0.2), after the rotation


def sample_bake_draws(generator: torch.Generator, n_bake: int) -> BakeDraws:
    """Draw ``n_bake`` bakes from a CPU ``generator``: grayscale with p 0.1,
    an angle U(-90, 90), a flip with p 0.2."""
    u = torch.rand((n_bake, 3), generator=generator)
    return BakeDraws(gray=tuple((u[:, 0] < 0.1).tolist()), angles=u[:, 1] * 180.0 - 90.0,
                     flip=tuple((u[:, 2] < 0.2).tolist()))


def bake_patches(patches: torch.Tensor, draws: BakeDraws, i: int) -> torch.Tensor:
    """Bake ``i`` of a slide's float patches (N, P, P, 3): the grayscale
    image in every channel if drawn (``augment.luma``), the nearest-neighbour
    rotation by the bake's angle (``augment.rotate_batch``), then, if drawn,
    the horizontal flip of the rotated image on the W axis (the JAX
    ``im2[:, ::-1, :]``; ``rotate_batch``'s ``hflip`` would mirror before)."""
    x = patches
    if draws.gray[i]:
        x = augment.luma(x)[..., None].expand_as(x)
    x = augment.rotate_batch(x, draws.angles[i].to(x.device).expand(x.shape[0]))
    return x.flip(2) if draws.flip[i] else x


def _model_args(cfg: BaselineConfig, patches: torch.Tensor, batch) -> tuple:
    args = (patches, batch["positions"])
    return args + (batch["adj"],) if cfg.model in _USES_ADJ else args


def slide_loss(model, cfg: BaselineConfig, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None, bakes=None) -> torch.Tensor:
    """The loss of one padded slide in train mode (the batch norms' running
    stats move, chained through every forward): the masked MSE; for Hist2ST
    also zinb_coef x the masked ZINB (NB with ``cfg.nb``) of the batch's
    ``counts`` when it has them, and lamb x masked_mse(new_pred, pred) over
    ``resolve_bake(cfg)`` train-mode passes on baked patches, new_pred their
    coef-softmax-weighted sum (their mean without a coef head), gradients
    through every pass.

    ``generator``: the step's dropout generator, set on the model's dropouts
    for the first pass; bake i's dropout draws from a generator reseeded by
    (its initial seed, i + 1), as JAX folds i + 1 into the dropout key.
    Without one the dropouts keep the generator they have. ``bakes``:
    Hist2ST's ``BakeDraws`` or the baked patches themselves (n_bake, N, P,
    P, 3); by default drawn by ``sample_bake_draws`` from a CPU generator
    reseeded by (``generator``'s initial seed, 0)."""
    model.train()
    if generator is not None:
        seed_dropout(model, generator)
    patches = augment.to_float(batch["patches"])  # the jitted JAX loss's scaling
    mask = batch["mask"]
    out = model(*_model_args(cfg, patches, batch), mask=mask)
    if cfg.model != "hist2st":
        return masked_mse(out, batch["expression"], mask)
    pred, extra, _ = out
    loss = masked_mse(pred, batch["expression"], mask)
    if extra is not None and "counts" in batch:
        if cfg.nb:
            ll = bl.nb_loss(batch["counts"], *extra, mask=mask)
        else:
            ll = bl.zinb_loss(batch["counts"], *extra, batch["size_factors"], mask=mask)
        loss = loss + cfg.zinb_coef * ll
    n_bake = resolve_bake(cfg)
    if n_bake == 0:
        return loss
    if bakes is None:
        if generator is None:
            raise ValueError("Hist2ST's bakes need draws: pass bakes= or the step's generator")
        bakes = sample_bake_draws(augment.reseed(torch.Generator(), generator.initial_seed(), 0),
                                  n_bake)
    bake_generator = None if generator is None else torch.Generator(device=generator.device)
    preds, coefs = [], []
    for i in range(n_bake):
        if bake_generator is not None:
            seed_dropout(model, augment.reseed(bake_generator, generator.initial_seed(), i + 1))
        baked = bake_patches(patches, bakes, i) if isinstance(bakes, BakeDraws) else bakes[i]
        bp, _, bc = model(*_model_args(cfg, baked, batch), mask=mask, aug=model.coef_head)
        preds.append(bp)
        coefs.append(bc)
    if model.coef_head:
        # per spot, a softmax of coef(h) across the bakes (HIST2ST.py:133-141)
        new_pred = (torch.stack(preds) * torch.softmax(torch.stack(coefs), dim=0)).sum(dim=0)
    else:
        new_pred = torch.stack(preds).mean(dim=0)
    return loss + cfg.lamb * masked_mse(new_pred, pred, mask)


def baseline_lr(cfg: BaselineConfig, step: int, steps_per_epoch: int = 1) -> float:
    """The learning rate of the optimizer's ``step``-th update (0-based): the
    family's, and for Hist2ST StepLR(lr_step_epochs, lr_gamma) stepped once
    per epoch of ``steps_per_epoch`` updates, lr * gamma^((step //
    steps_per_epoch) // lr_step_epochs), the JAX build's optax schedule."""
    lr = resolve_lr(cfg)
    if cfg.model == "hist2st" and cfg.lr_step_epochs > 0:
        epoch = step // max(1, steps_per_epoch)
        return lr * cfg.lr_gamma ** (epoch // cfg.lr_step_epochs)
    return lr


def make_slide_step(cfg: BaselineConfig, steps_per_epoch: int = 1) -> Callable:
    """The step: (state, padded slide tensors, dropout generator[, Hist2ST's
    bakes]) -> loss, one optimizer step on ``slide_loss`` at
    ``baseline_lr``; updates the state in place. A torch.profiler trace
    shows it as a "slide_step" range around the flagship step's phase
    names, "forward", "backward" and "optimizer"."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: torch.Generator, bakes=None) -> torch.Tensor:
        with record_function("slide_step"):
            with record_function("forward"):
                loss = slide_loss(state.model, cfg, batch, generator, bakes)
            with record_function("backward"):
                state.optimizer.zero_grad(set_to_none=True)
                loss.backward()
            with record_function("optimizer"):
                for group in state.optimizer.param_groups:
                    group["lr"] = baseline_lr(cfg, state.step, steps_per_epoch)
                state.optimizer.step()
            state.step += 1
            return loss.detach()

    return step


def _running_stats(model) -> Dict[str, torch.Tensor]:
    """The batch norms' running statistics and counters, by buffer name."""
    return {name: buf for name, buf in model.named_buffers()
            if name.endswith(("running_mean", "running_var", "num_batches_tracked"))}


def make_slide_dp_step(cfg: BaselineConfig, steps_per_epoch: int = 1) -> Callable:
    """The slide-DP step (JAX ``make_slide_dp_step``): (state, this rank's
    padded slides, their dropout generators, group or None) -> the mean
    loss over the step's slides.

    Each slide's ``slide_loss`` runs from the same old running statistics
    and its gradient, divided by the rank's slide count, accumulates; the
    running statistics become the mean of the slides' updates (counters:
    one slide's). Over a ``group`` the gradients, the statistics and the
    loss are then averaged over the ranks, each of which took an equal
    share of the step's slides (or all of them): the mean over every
    slide. One optimizer step at ``baseline_lr``."""

    def step(state: TrainState, slides, generators, group=None) -> torch.Tensor:
        model = state.model
        stats = _running_stats(model)
        old = {k: v.clone() for k, v in stats.items()}
        new = {k: torch.zeros_like(v) for k, v in stats.items() if v.is_floating_point()}
        state.optimizer.zero_grad(set_to_none=True)
        total = torch.zeros((), device=next(model.parameters()).device)
        for batch, generator in zip(slides, generators):
            for k, v in stats.items():
                v.copy_(old[k])
            loss = slide_loss(model, cfg, batch, generator)
            (loss / len(slides)).backward()
            for k in new:
                new[k] += stats[k]
            total += loss.detach()
        for k, v in new.items():
            stats[k].copy_(v / len(slides))
        loss = total / len(slides)
        if group is not None:
            average_gradients(model.parameters(), group)
            world = torch.distributed.get_world_size(group)
            for v in [stats[k] for k in new] + [loss]:
                torch.distributed.all_reduce(v, group=group)
                v /= world
        for g in state.optimizer.param_groups:
            g["lr"] = baseline_lr(cfg, state.step, steps_per_epoch)
        state.optimizer.step()
        state.step += 1
        return loss

    return step


def baseline_optimizer(cfg: BaselineConfig, params) -> torch.optim.Optimizer:
    """The family's reference optimizer: torch Adam (coupled L2) for the
    slide families (Hist2ST's StepLR is applied by the step,
    ``baseline_lr``), AdamW (decoupled decay, optax's ``adamw``) for BLEEP."""
    lr, wd = resolve_lr(cfg), resolve_weight_decay(cfg)
    if cfg.model == "bleep":
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd)
    return torch_adam(params, lr, wd)


def init_baseline(cfg: BaselineConfig, device="cuda", attn_backend: str = "xla") -> TrainState:
    """The family's model on ``device``, its parameters drawn from a
    generator seeded with ``cfg.seed``, and a fresh optimizer."""
    device = torch.device(device)
    model = build_baseline(cfg, device, attn_backend)
    init_baseline_parameters(model, torch.Generator(device=device).manual_seed(cfg.seed))
    return TrainState(model, baseline_optimizer(cfg, model.parameters()))


def train_baseline_fold(cfg: BaselineConfig, sections: Sequence[Section], fold: int,
                        logger: Optional[MetricLogger] = None, device="cuda",
                        attn_backend: str = "xla", mesh=None,
                        slides_per_step: int = 1) -> TrainState:
    """Leave-one-out training of a slide-level baseline on ``device``: the
    reference's one slide per optimizer step, every epoch over the training
    sections in ``np.random.default_rng(cfg.seed)`` order (an epoch is
    len(training sections) steps, which Hist2ST's StepLR counts). Returns
    the state; one ``MetricLogger`` record per epoch.

    ``mesh`` and/or ``slides_per_step`` > 1 switch to the slide-DP mode
    (``make_slide_dp_step``): D = ``slides_per_step`` slides a step, or the
    mesh's "data" size without one, consecutive in the epoch's order, each
    slide's dropout keyed by (seed, epoch * 1000 + slide) as in the
    sequential mode; under a mesh each rank takes ``batch_rows`` of every
    step's slides."""
    logger = logger or MetricLogger()
    device = torch.device(device)
    train_secs, _ = split_fold(sections, fold)
    state = init_baseline(cfg, device, attn_backend)
    with_adj = cfg.model in _USES_ADJ
    order_rng = np.random.default_rng(cfg.seed)
    generator = torch.Generator(device=device)
    if mesh is None and slides_per_step <= 1:
        step = make_slide_step(cfg, steps_per_epoch=len(train_secs))
        padded = [slide_tensors(pad_slide(s, cfg.bucket, with_adj, cfg), device)
                  for s in train_secs]
        for epoch in range(resolve_epochs(cfg)):
            meter = AvgMeter("loss")
            for i in order_rng.permutation(len(padded)):
                dropout_rng = augment.reseed(generator, cfg.seed, epoch * 1000 + int(i))
                meter.update(float(step(state, padded[i], dropout_rng)))
            logger.log(model=cfg.model, fold=fold, epoch=epoch, loss=meter.avg)
        return state

    group = None
    d_slides = slides_per_step
    if mesh is not None:
        check_data_mesh(mesh)
        group, n_data, _ = mesh_axis(mesh)
        d_slides = slides_per_step if slides_per_step > 1 else n_data
    step = make_slide_dp_step(cfg, steps_per_epoch=-(-len(train_secs) // d_slides))
    # one common padded extent: every slide pads to the set's largest bucket
    target = max(-(-s.num_spots // cfg.bucket) * cfg.bucket for s in train_secs)
    padded = [slide_tensors(pad_slide(s, target, with_adj, cfg), device) for s in train_secs]
    generators = [torch.Generator(device=device) for _ in range(d_slides)]
    for epoch in range(resolve_epochs(cfg)):
        meter = AvgMeter("loss")
        perm = order_rng.permutation(len(padded))
        for start in range(0, len(perm), d_slides):
            chunk = perm[start:start + d_slides]
            mine = chunk[batch_rows(len(chunk), mesh)] if mesh is not None else chunk
            keyed = [augment.reseed(g, cfg.seed, epoch * 1000 + int(i))
                     for g, i in zip(generators, mine)]
            loss = step(state, [padded[i] for i in mine], keyed, group)
            meter.update(float(loss), len(chunk))
        logger.log(model=cfg.model, fold=fold, epoch=epoch, loss=meter.avg)
    return state


@torch.no_grad()
def predict_slide(model, section: Section, cfg: BaselineConfig) -> np.ndarray:
    """(N, G) predictions for one section, in eval mode on the model's
    device (Hist2ST's first output)."""
    device = next(model.parameters()).device
    batch = slide_tensors(pad_slide(section, cfg.bucket, cfg.model in _USES_ADJ, cfg), device)
    model.eval()
    out = model(*_model_args(cfg, to_float_eager(batch["patches"]), batch), mask=batch["mask"])
    pred = out[0] if cfg.model == "hist2st" else out
    return pred[: section.num_spots].cpu().numpy()


def evaluate_baseline_fold(cfg: BaselineConfig, sections: Sequence[Section], fold: int,
                           model) -> Dict[str, float]:
    """Per-gene PCC / MSE / MAE of the held-out slide ``sections[fold]``."""
    test = sections[fold]
    return expression_metrics(predict_slide(model, test, cfg), test.expression)


def make_bleep_step(cfg: BaselineConfig) -> Callable:
    """BLEEP's step: (state, {"image_u8", "expression"} on the model's
    device, dropout generator[, shard]) -> loss; the images scaled as the
    jitted JAX step scales them (``augment.to_float``), the CLIP loss, one
    AdamW step. Under a ``train.step.Shard`` the images are the rank's rows
    of the global batch and the expression all of it: the rank's rows of
    both towers, global batch norms, the global batch's dropout masks
    sliced, ``bleep_clip_loss_gathered``, the gradients averaged over the
    ranks (a replicated batch: the whole step on every rank)."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: torch.Generator, shard: Optional[Shard] = None) -> torch.Tensor:
        model = state.model
        model.train()
        seed_dropout(model, generator)
        images = augment.to_float(batch["image_u8"])
        if shard is None or shard.replicated:
            image_emb, spot_emb = model({"image": images, "expression": batch["expression"]})
            loss = bl.bleep_clip_loss(spot_emb, image_emb, cfg.temperature)
        else:
            with global_batch_stats(model.image_encoder, shard.group), \
                    dropout_rows([model], shard.rows.start, shard.total):
                image_emb, spot_emb = model({"image": images,
                                             "expression": batch["expression"][shard.rows]})
            loss = bl.bleep_clip_loss_gathered(spot_emb, image_emb, cfg.temperature,
                                               shard.group)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if shard is not None:
            average_gradients(model.parameters(), shard.group)
        state.optimizer.step()
        state.step += 1
        return loss.detach()

    return step


def train_bleep_fold(cfg: BaselineConfig, sections: Sequence[Section], fold: int,
                     logger: Optional[MetricLogger] = None, device="cuda",
                     mesh=None) -> TrainState:
    """BLEEP's leave-one-out fold on ``device``: the training sections on the
    device (``DeviceResidentData``), the shared pipeline's shuffled batches of
    ``cfg.batch_size`` (remainder kept), dropout keyed by (seed, epoch *
    100000 + batch). One ``MetricLogger`` record per epoch, the loss averaged
    over spots. ``mesh``: data parallelism over its "data" axis, the
    one-process objective on the global batch (``make_bleep_step``)."""
    logger = logger or MetricLogger()
    device = torch.device(device)
    train_secs, _ = split_fold(sections, fold)
    data = DeviceResidentData(ConcatSections.from_sections(train_secs), device)
    state = init_baseline(cfg, device)
    step = make_bleep_step(cfg)
    generator = torch.Generator(device=device)
    if mesh is not None:
        check_data_mesh(mesh)
    for epoch in range(resolve_epochs(cfg)):
        meter = AvgMeter("loss")
        pending = []  # (loss tensor, batch size): read once per epoch
        batches = device_train_batches(data, cfg.batch_size, cfg.seed, epoch, mesh)
        for i, batch in enumerate(batches):
            bs = len(batch["expression"])
            rng = augment.reseed(generator, cfg.seed, epoch * 100000 + i)
            pending.append((step(state, batch, rng, batch_shard(mesh, bs)), bs))
        for loss, n in pending:
            meter.update(float(loss), n)
        logger.log(model="bleep", fold=fold, epoch=epoch, loss=meter.avg)
    return state


@torch.no_grad()
def bleep_embeddings(model, sections: Sequence[Section],
                     batch_size: int = 32) -> Tuple[np.ndarray, np.ndarray]:
    """(image, spot) projections of every spot of ``sections``, in order, for
    retrieval: sequential batches in eval mode, the images divided eagerly
    (``to_float_eager``), as JAX's ``bleep_embeddings``."""
    device = next(model.parameters()).device
    model.eval()
    img_out, spot_out = [], []
    for batch in eval_batches(ConcatSections.from_sections(sections), batch_size):
        images = to_float_eager(torch.from_numpy(batch["image_u8"]).to(device))
        ie, se = model({"image": images,
                        "expression": torch.from_numpy(batch["expression"]).to(device)})
        img_out.append(ie)
        spot_out.append(se)
    return torch.cat(img_out).cpu().numpy(), torch.cat(spot_out).cpu().numpy()
