"""The train step: augment -> towers -> InfoNCE -> Adam.

Port of ``mclstexp_tpu/train/step.py`` for augment modes "st" (jitter,
flip, rotate; the ST datasets), "tenx" (flips and quarter turns; Visium)
and "none". PyTorch runs eagerly, so the step is a plain function that
updates the state in place and returns the loss tensor (no host sync).

Data parallelism (a ``Shard``): JAX's step on a sharded batch computes the
one-device step on the global batch. The port's rank holds its rows of the
global batch's images and every row of its expression and positions. The
image tower runs on the rank's rows with batch statistics over every rank
(``models.image.common.global_batch_stats``), and its dropout draws the
global batch's masks and keeps the rank's rows; the spot tower attends over
the whole batch, as one process does; both towers' rows of this rank enter
``symmetric_infonce_gathered``, the same global loss on every rank; after
the backward ``parallel.collectives.average_gradients`` gives every rank
the one-process gradient, and each takes the same Adam step. A batch whose
length the ranks do not divide is replicated: every rank takes the
one-process step on all of it, and the average keeps the ranks equal.

On a mesh with other axes beside "data" (JAX's (data, seq) and (data,
model) meshes) the ``Shard``'s group is the "data" axis's
(``batch_shard``): the batch norms, the gathered loss and the gradient
average act over it alone, and the ranks along "seq" and "model" compute
the same step, so their gradients are already equal. Under
``parallel.mesh.active_mesh`` a "ring" spot tower splits its sequence over
the mesh's "seq" axis; a model placed by ``parallel.tp.shard_params``
computes its sharded products over "model", and ``average_gradients``
reduces its gradients' local shards.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch.profiler import record_function

from mclstexp_tpu_torch.core.layers import compute_dtype_of, dropout_rows, seed_dropout
from mclstexp_tpu_torch.core.losses import symmetric_infonce, symmetric_infonce_gathered
from mclstexp_tpu_torch.models.image.common import global_batch_stats
from mclstexp_tpu_torch.ops import augment
from mclstexp_tpu_torch.parallel.collectives import average_gradients
from mclstexp_tpu_torch.parallel.mesh import batch_rows, mesh_axis
from mclstexp_tpu_torch.train.state import TrainState

AUGMENT_MODES = ("st", "tenx", "none")


@dataclasses.dataclass(frozen=True)
class Shard:
    """This rank's part of a data-parallel step: ``rows`` of a global batch
    of ``total`` rows over the ranks of ``group``; ``replicated`` when the
    ranks do not divide the batch (``rows`` is then all of it)."""

    group: object
    rows: slice
    total: int
    replicated: bool


def batch_shard(mesh, total: int) -> Optional[Shard]:
    """The ``Shard`` of a global batch of ``total`` rows over ``mesh``'s
    "data" axis (``parallel.mesh.batch_rows``'s rule); None without a mesh."""
    if mesh is None:
        return None
    group, n_shards, _ = mesh_axis(mesh)
    return Shard(group, batch_rows(total, mesh), total, replicated=total % n_shards != 0)


def make_train_step(augment_mode: str = "st", rot_impl: str = "paeth",
                    tenx_raw_scale: bool = False) -> Callable:
    """Build the step: (state, batch, draws[, generator][, shard]) -> loss.

    batch: {"image_u8": (B, P, P, 3) uint8, "expression": (B, G) float32,
    "position": (B, 2) int}, on the model's device; under a ``shard`` the
    images are the rank's rows only. draws: the ``augment.StDraws`` of the
    batch's images for "st", its ``augment.TenxDraws`` for "tenx", ignored
    for "none". ``generator``: the step's generator, from which the
    dropouts draw (``core.layers.seed_dropout``). ``tenx_raw_scale`` feeds
    the "tenx" images on the raw 0-255 scale
    (``DataConfig.visium_raw_scale``).
    """
    if augment_mode not in AUGMENT_MODES:
        raise NotImplementedError(
            f"augment_mode {augment_mode!r}: the port has {AUGMENT_MODES}"
        )

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             draws: Optional[augment.StDraws | augment.TenxDraws] = None,
             generator: Optional[torch.Generator] = None,
             shard: Optional[Shard] = None) -> torch.Tensor:
        # The named ranges label the step and its phases in a torch.profiler
        # trace (profile_step.py; the benchmark counts the launches inside
        # "train_step").
        with record_function("train_step"):
            model = state.model
            # the "st" augmentation computes in the model's dtype (JAX step.py:42-48)
            aug_dtype = compute_dtype_of(model.config.dtype)
            with record_function("augment"):
                if augment_mode == "st":
                    images = augment.train_augment_inline(batch["image_u8"], draws,
                                                          dtype=aug_dtype, rot_impl=rot_impl)
                elif augment_mode == "tenx":
                    images = augment.tenx_augment(batch["image_u8"], draws,
                                                  raw_scale=tenx_raw_scale)
                else:
                    images = augment.to_float(batch["image_u8"])
            model.train()
            if generator is not None:
                seed_dropout(model, generator)
            temperature = model.config.temperature
            with record_function("forward"):
                if shard is None or shard.replicated:
                    image_emb, spot_emb = model(
                        {"image": images, "expression": batch["expression"],
                         "position": batch["position"]}
                    )
                    loss = symmetric_infonce(spot_emb, image_emb, temperature)
                else:
                    with global_batch_stats(model.tower, shard.group), \
                            dropout_rows(model.image_side, shard.rows.start, shard.total):
                        image_emb = model.encode_image(images)
                    spot_emb = model.encode_spots(batch["expression"], batch["position"])
                    loss = symmetric_infonce_gathered(spot_emb[shard.rows], image_emb,
                                                      temperature, shard.group)
            with record_function("backward"):
                state.optimizer.zero_grad(set_to_none=True)
                loss.backward()
                if shard is not None:
                    average_gradients(model.parameters(), shard.group)
            with record_function("optimizer"):
                state.optimizer.step()
            state.step += 1
            return loss.detach()

    return step
