"""Embedding sweep: run every section through both towers of one model.

Port of ``mclstexp_tpu/infer/embed.py`` (the reference's phase A). All
sections are concatenated and batched sequentially at B=32; the spot tower
sees *each batch as one attention sequence*, so batch boundaries, including
ones that straddle two sections, are part of the model's input, and the
remainder batch is kept. The image tower is independent per spot in eval
mode (BatchNorm on running statistics), so it runs at a larger batch.

Output layout matches the reference: ``<out_dir>/img_embeddings_<i+1>.npy``
and ``spot_embeddings_<i+1>.npy``, stored transposed (P, N_i) per section.

``compute_embeddings_sharded`` runs the same batches over the ranks of a
mesh (``parallel/mesh.py``) and gathers them back in order.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mclstexp_tpu_torch.data.pipeline import ConcatSections
from mclstexp_tpu_torch.data.section import Section
from mclstexp_tpu_torch.models.mclstexp import MclSTExp
from mclstexp_tpu_torch.ops import augment
from mclstexp_tpu_torch.parallel.mesh import mesh_axis


def prepare_eval_arrays(sections: Sequence[Section], with_patches: bool = True,
                        device="cuda") -> Dict[str, object]:
    """Move the concatenated eval arrays to ``device`` once.

    The LOO protocol embeds the same sections under every fold's model, so
    one upload serves every fold. ``with_patches=False`` skips the patches
    (the largest transfer) for spot-tower-only consumers such as the serving
    database. "expression" is the model input (per-spot normalization);
    "eval_expression" the retrieval-key and ground-truth normalization (per
    gene, ``Section.eval_expression``), the same tensor when no section
    carries raw counts.
    """
    device = torch.device(device)
    if with_patches:
        data = ConcatSections.from_sections(sections)
        n, patches = len(data), torch.from_numpy(np.ascontiguousarray(data.patches))
        expression, positions = data.expression, data.positions
    else:
        n, patches = sum(s.num_spots for s in sections), None
        expression = np.concatenate([s.expression for s in sections], axis=0)
        positions = np.concatenate([s.positions for s in sections], axis=0)
    prepared = {
        "n": n,
        "patches": None if patches is None else patches.to(device),
        "expression": torch.from_numpy(expression).to(device),
        "positions": torch.from_numpy(positions).long().to(device),
    }
    if any(s.counts is not None for s in sections):
        prepared["eval_expression"] = torch.from_numpy(
            np.concatenate([s.eval_expression for s in sections], axis=0)).to(device)
    else:
        prepared["eval_expression"] = prepared["expression"]
    return prepared


def _check_model_device(model: MclSTExp, device: torch.device) -> None:
    param = next(model.parameters())
    if param.device.type != device.type:
        raise ValueError(f"the model is on {param.device}, the sweep on {device}")


def sample_eval_draws(seed: int, batch_index: int, batch: int, device) -> augment.TenxDraws:
    """The "tenx" draws of image batch ``batch_index`` of a sweep seeded by
    ``seed``, keyed by both as the JAX sweep keys them (``fold_in(PRNGKey(
    seed), batch_index)``): the same images get the same transform
    whatever was swept before."""
    generator = augment.reseed(torch.Generator(device=device), seed, batch_index)
    return augment.sample_tenx_draws(generator, batch, device)


def _image_input(patches_u8: torch.Tensor, eval_augment: bool, raw_scale: bool, seed: int,
                 batch_index: int) -> torch.Tensor:
    if eval_augment:
        draws = sample_eval_draws(seed, batch_index, len(patches_u8), patches_u8.device)
        return augment.tenx_augment(patches_u8, draws, raw_scale=raw_scale)
    return patches_u8.float() if raw_scale else augment.to_float(patches_u8)


@torch.no_grad()
def compute_embeddings(
    model: MclSTExp,
    sections: Sequence[Section],
    batch_size: int = 32,
    eval_augment: bool = False,
    seed: int = 0,
    prepared=None,
    raw_scale: bool = False,
    image_batch_size: Optional[int] = None,
    as_device: bool = False,
    tower: str = "both",
    device="cuda",
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """(image_embeddings, spot_embeddings), each (sum N_i, P) in section
    order; batches of ``batch_size`` cross section boundaries.

    The model runs in eval mode (its previous mode is restored). raw_scale
    keeps the raw 0-255 float input scale. ``eval_augment`` applies the
    Visium inference-time "tenx" flips and rotations to each image batch,
    its draws from ``sample_eval_draws(seed, batch index)``.
    ``as_device=True`` returns tensors on ``device`` instead of ndarrays.
    ``tower="image"``/``"spot"`` runs only that sweep (the other return is
    None); the spot sweep needs no patches.
    """
    if tower not in ("both", "image", "spot"):
        raise ValueError(f"tower must be 'both', 'image' or 'spot', got {tower!r}")
    device = torch.device(device)
    _check_model_device(model, device)
    if prepared is None:
        prepared = prepare_eval_arrays(sections, with_patches=(tower != "spot"), device=device)
    n = prepared["n"]
    was_training = model.training
    model.eval()
    try:
        img = spot = None
        if tower in ("both", "image"):
            patches = prepared["patches"]
            bs = image_batch_size or max(batch_size, 256)
            # A contiguous NHWC float batch: the tower's NCHW view of it is
            # channels_last, the layout cuDNN runs fastest.
            img = torch.cat([
                model.encode_image(_image_input(patches[s:s + bs], eval_augment, raw_scale,
                                                seed, i))
                for i, s in enumerate(range(0, n, bs))
            ])
        if tower in ("both", "spot"):
            expr, pos = prepared["expression"], prepared["positions"]
            spot = torch.cat([
                model.encode_spots(expr[s:s + batch_size], pos[s:s + batch_size])
                for s in range(0, n, batch_size)
            ])
    finally:
        model.train(was_training)
    if as_device:
        return img, spot
    return (None if img is None else img.cpu().numpy(),
            None if spot is None else spot.cpu().numpy())


def _sharded_tower(encode, arrays: Sequence[torch.Tensor], n: int, bs: int, width: int,
                   group, n_dev: int, me: int) -> torch.Tensor:
    """One tower over the sharded sweep: the n // bs full batches, padded to a
    multiple of ``n_dev``, each rank encoding its contiguous block of them,
    then an ``all_gather`` in rank order; the tail batch on every rank."""
    full = n - n % bs
    nb = full // bs
    outs = []
    if nb:
        per_rank = -(-nb // n_dev)
        mine = [encode(*[a[b * bs:(b + 1) * bs] for a in arrays])
                for b in range(me * per_rank, min((me + 1) * per_rank, nb))]
        block = torch.zeros(per_rank * bs, width, device=arrays[0].device)
        if mine:  # padding batches past nb stay zero and are dropped below
            block[:len(mine) * bs] = torch.cat(mine)
        parts = [torch.empty_like(block) for _ in range(n_dev)]
        dist.all_gather(parts, block, group=group)
        outs.append(torch.cat(parts)[:full])
    if full < n:  # the tail batch, unsharded, as the one-card sweep runs it
        outs.append(encode(*[a[full:] for a in arrays]))
    return torch.cat(outs)


@torch.no_grad()
def compute_embeddings_sharded(
    model: MclSTExp,
    sections: Sequence[Section],
    mesh,
    batch_size: int = 32,
    raw_scale: bool = False,
    prepared=None,
    axis: str = "data",
    image_batch_size: Optional[int] = None,
    as_device: bool = False,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """The embedding sweep over the ranks of ``mesh``'s ``axis``: each tower's
    full batches split into contiguous blocks, one per rank, gathered back
    in the original order on every rank; the tail batch runs unsharded.

    Each spot batch is still exactly one ``batch_size`` attention sequence in
    the original order, so every batch's output is ``compute_embeddings``'
    (batches merely run on different ranks). The image tower, independent
    per spot in eval mode, runs at ``image_batch_size or max(batch_size,
    256)``. The Visium eval-time augmentation is not supported here (its
    draws are defined per batch of the one-card sweep), as in the JAX
    package. Returns (image, spot) embeddings as host ndarrays, or tensors
    on ``device`` under ``as_device``."""
    device = torch.device(device)
    _check_model_device(model, device)
    group, n_dev, me = mesh_axis(mesh, axis)
    if prepared is None:
        prepared = prepare_eval_arrays(sections, device=device)
    n = prepared["n"]
    image_bs = image_batch_size or max(batch_size, 256)
    width = model.config.projection_dim
    was_training = model.training
    model.eval()
    try:
        img = _sharded_tower(
            lambda p: model.encode_image(p.float() if raw_scale else augment.to_float(p)),
            (prepared["patches"],), n, image_bs, width, group, n_dev, me)
        spot = _sharded_tower(model.encode_spots,
                              (prepared["expression"], prepared["positions"]), n, batch_size,
                              width, group, n_dev, me)
    finally:
        model.train(was_training)
    if as_device:
        return img, spot
    return img.cpu().numpy(), spot.cpu().numpy()


def split_by_section(embeddings, section_sizes: Sequence[int]) -> List:
    """Rows of the concatenation, one piece per section (ndarray or tensor)."""
    if sum(section_sizes) != len(embeddings):
        raise ValueError(f"section sizes sum to {sum(section_sizes)}, "
                         f"embeddings have {len(embeddings)} rows")
    out, start = [], 0
    for n in section_sizes:
        out.append(embeddings[start:start + n])
        start += n
    return out


def save_embedding_files(img: np.ndarray, spot: np.ndarray, sizes: Sequence[int],
                         out_dir: str) -> None:
    """Write embeddings in the reference's per-section transposed (P, N_i)
    .npy layout."""
    img, spot = np.asarray(img), np.asarray(spot)
    os.makedirs(out_dir, exist_ok=True)
    for i, (im, sp) in enumerate(zip(split_by_section(img, sizes),
                                     split_by_section(spot, sizes))):
        np.save(os.path.join(out_dir, f"img_embeddings_{i + 1}.npy"), im.T)
        np.save(os.path.join(out_dir, f"spot_embeddings_{i + 1}.npy"), sp.T)


def dump_embeddings(model: MclSTExp, sections: Sequence[Section], out_dir: str,
                    batch_size: int = 32, eval_augment: bool = False,
                    raw_scale: bool = False, device="cuda") -> None:
    """Write the reference-compatible per-section transposed .npy files."""
    img, spot = compute_embeddings(model, sections, batch_size, eval_augment,
                                   raw_scale=raw_scale, device=device)
    save_embedding_files(img, spot, [s.num_spots for s in sections], out_dir)
