"""Fold-loop trainer, port of ``train_fold`` and ``train_all_folds`` of
``mclstexp_tpu/train/loop.py``.

Leave-one-section-out retraining from scratch per fold, with periodic and
final checkpoints, resume from the fold's checkpoint, JSONL metrics and
seeded determinism: the batch order comes from ``SeedSequence([seed,
epoch])``, and each step's augmentation draws from a ``torch.Generator`` on
the device seeded by (``seed + 1000 * fold``, epoch, step), as the JAX
build's ``fold_in(PRNGKey(seed + 1000 * fold), epoch * 100000 + step)``, so
that a resumed fold takes the draws of an uninterrupted one; the dropouts
draw from the same generator after them. The ST datasets train with the
"st" augmentation, Visium with "tenx" (``DataConfig.visium_raw_scale``
picks its input scale).

The training set stays on the device when its bytes fit
``TrainConfig.device_data_budget_bytes`` and is streamed through
``prefetch_to_device`` otherwise, as in JAX; both give the same batches.

Data parallelism: under a mesh (``parallel.mesh.train_mesh`` from
``TrainConfig.mesh_shape`` / ``mesh_axes``, over every rank of the process
group by default) every rank walks the same global batches, draws the
augmentation for the whole batch and keeps its rows, and takes the
data-parallel step (``train.step.Shard``): each step is one process's step
on the global batch. Rank 0 alone writes the checkpoints; every rank waits
for them at a barrier, so none reads a half-written file.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from mclstexp_tpu_torch.config import Config
from mclstexp_tpu_torch.data.pipeline import (
    ConcatSections,
    DeviceResidentData,
    device_train_batches,
    num_train_steps,
    prefetch_to_device,
    raw_bytes,
    split_fold,
    train_batches,
)
from mclstexp_tpu_torch.data.section import Section
from mclstexp_tpu_torch.ops import augment
from mclstexp_tpu_torch.parallel.mesh import check_data_mesh, train_mesh
from mclstexp_tpu_torch.train import checkpoint as ckpt
from mclstexp_tpu_torch.train.state import TrainState, create_train_state
from mclstexp_tpu_torch.train.step import batch_shard, make_train_step
from mclstexp_tpu_torch.utils.logging import MetricLogger
from mclstexp_tpu_torch.utils.meters import AvgMeter, Stopwatch


def check_positions_in_vocab(sections: Sequence[Section], pos_vocab: int) -> None:
    """Raise if any spot coordinate would index past the positional tables
    or is negative (an embedding lookup would fail far from the cause)."""
    for s in sections:
        m = int(np.max(s.positions)) if s.num_spots else 0
        if m >= pos_vocab:
            raise ValueError(
                f"section {s.name}: position coordinate {m} >= pos_vocab "
                f"{pos_vocab}; raise ModelConfig.pos_vocab, or remap raw "
                f"coords to dense rows first (DataConfig.pos_remap)"
            )
        lo = int(np.min(s.positions)) if s.num_spots else 0
        if lo < 0:
            raise ValueError(
                f"section {s.name}: negative position coordinate {lo} — "
                f"corrupted spot file or a bad coordinate remap"
            )


def train_fold(cfg: Config, sections: Sequence[Section], fold: int,
               logger: Optional[MetricLogger] = None, device="cuda",
               resume: bool = False, mesh=None) -> TrainState:
    """Train one leave-one-out fold on ``device``; returns the final state.
    Checkpoints land in ``<checkpoint_dir>/<dataset>/<test
    section>/best_<fold>``. With ``resume`` and a checkpoint there, the
    state (model, Adam, step) is restored and training goes on from epoch
    ``step // steps_per_epoch``; otherwise the fold starts from scratch.
    ``mesh``: the data-parallel mesh; by default ``train_mesh`` of the
    config (None for one process without a group)."""
    logger = logger or MetricLogger()
    device = torch.device(device)
    check_positions_in_vocab(sections, cfg.model.pos_vocab)
    if mesh is None:
        mesh = train_mesh(cfg.train.mesh_shape, cfg.train.mesh_axes, device)
    else:
        check_data_mesh(mesh)
    train_secs, test_sec = split_fold(sections, fold)
    data = ConcatSections.from_sections(train_secs)
    resident = None
    if raw_bytes(data) <= cfg.train.device_data_budget_bytes:
        resident = DeviceResidentData(data, device)
    state = create_train_state(cfg.model, cfg.train, device)
    ckpt_dir = ckpt.fold_checkpoint_dir(
        cfg.train.checkpoint_dir, cfg.data.dataset, test_sec.name, fold
    )
    start_epoch = 0
    if resume and os.path.exists(os.path.join(ckpt_dir, ckpt.STATE_FILE)):
        ckpt.apply_checkpoint(state, ckpt.restore_checkpoint(ckpt_dir, device))
        start_epoch = state.step // max(num_train_steps(len(data), cfg.train.batch_size), 1)
        logger.log(event="resume", fold=fold, epoch=start_epoch)

    if cfg.data.dataset == "visium":
        step_fn = make_train_step("tenx", tenx_raw_scale=cfg.data.visium_raw_scale)
        sample_draws = augment.sample_tenx_draws
    else:
        step_fn = make_train_step("st", rot_impl=cfg.train.rot_impl)
        sample_draws = augment.sample_st_draws
    generator = torch.Generator(device=device)
    base_seed = cfg.train.seed + 1000 * fold

    for epoch in range(start_epoch, cfg.train.max_epochs):
        loss_meter = AvgMeter("train_loss")
        watch = Stopwatch()  # per-epoch rate (epoch 0 includes warm-up)
        # Losses stay on the device until a sync point: a per-step float()
        # waits for the step to finish.
        pending = []  # (loss tensor, batch size)
        if resident is not None:
            batches = device_train_batches(resident, cfg.train.batch_size, cfg.train.seed,
                                           epoch, mesh)
        else:
            batches = prefetch_to_device(
                train_batches(data, cfg.train.batch_size, cfg.train.seed, epoch), device, mesh)
        for i, batch in enumerate(batches):
            bs = len(batch["expression"])  # the global batch
            draws = sample_draws(augment.reseed(generator, base_seed, epoch, i), bs, device)
            shard = batch_shard(mesh, bs)
            if shard is not None:
                draws = augment.take_rows(draws, shard.rows)
            pending.append((step_fn(state, batch, draws, generator, shard), bs))
            watch.update(bs)
            if cfg.train.log_every and (i + 1) % cfg.train.log_every == 0:
                for val, n in pending:
                    loss_meter.update(float(val), n)
                pending.clear()
                logger.log(fold=fold, epoch=epoch, step=i + 1,
                           loss=loss_meter.avg, spots_per_sec=watch.rate)
        for val, n in pending:
            loss_meter.update(float(val), n)
        logger.log(fold=fold, epoch=epoch, epoch_loss=loss_meter.avg,
                   spots_per_sec=watch.rate)
        if cfg.train.checkpoint_every_epochs and (epoch + 1) % cfg.train.checkpoint_every_epochs == 0:
            ckpt_watch = Stopwatch()
            ckpt.save_checkpoint_on_lead(ckpt_dir, state)
            logger.log(event="checkpoint", fold=fold, epoch=epoch,
                       seconds=ckpt_watch.elapsed)

    final_watch = Stopwatch()
    ckpt.save_checkpoint_on_lead(ckpt_dir, state)
    logger.log(event="final_checkpoint", fold=fold, seconds=final_watch.elapsed)
    return state


def train_all_folds(cfg: Config, sections: Sequence[Section],
                    folds: Optional[Sequence[int]] = None,
                    logger: Optional[MetricLogger] = None, device="cuda") -> List[str]:
    """The reference's outer loop: every fold (all sections by default)
    trained from scratch, one after another, on the config's mesh
    (``train_mesh``). Returns the folds' checkpoint directories."""
    logger = logger or MetricLogger()
    folds = folds if folds is not None else range(len(sections))
    mesh = train_mesh(cfg.train.mesh_shape, cfg.train.mesh_axes, device)
    out = []
    for fold in folds:
        train_fold(cfg, sections, fold, logger=logger, device=device, mesh=mesh)
        out.append(ckpt.fold_checkpoint_dir(
            cfg.train.checkpoint_dir, cfg.data.dataset, sections[fold].name, fold))
    return out
