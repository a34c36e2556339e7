"""Synthetic spatial-transcriptomics sections (NumPy).

Port of ``make_section``/``make_dataset`` of ``mclstexp_tpu/data/synthetic.py``
(same seeds, same arrays): a latent z per spot drives both the patch
texture and the counts, so image patches are predictive of expression.
``make_spot_database`` builds a her2st-scale spot-side database from them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from mclstexp_tpu_torch.data.normalize import logcpm_panel
from mclstexp_tpu_torch.data.section import Section


def make_section(
    name: str,
    num_spots: int = 64,
    num_genes: int = 32,
    patch_size: int = 32,
    latent_dim: int = 4,
    seed: int = 0,
    gene_loadings: Optional[np.ndarray] = None,
) -> Section:
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(num_spots)))
    xs, ys = np.meshgrid(np.arange(side), np.arange(side))
    positions = np.stack([xs.ravel(), ys.ravel()], axis=1)[:num_spots].astype(np.int32)
    centers = (positions * patch_size + patch_size).astype(np.int32)

    z = rng.normal(size=(num_spots, latent_dim))
    if gene_loadings is None:
        gene_loadings = rng.normal(size=(latent_dim, num_genes))
    rates = np.exp(z @ gene_loadings * 0.5 + 1.0)
    counts = rng.poisson(rates).astype(np.float64)
    expression = logcpm_panel(counts)

    # Patch: base color from z[:3], plus a texture frequency from z[3:].
    patches = np.zeros((num_spots, patch_size, patch_size, 3), dtype=np.uint8)
    yy, xx = np.meshgrid(np.arange(patch_size), np.arange(patch_size), indexing="ij")
    for i in range(num_spots):
        base = 128 + 60 * np.tanh(z[i, :3])
        freq = 0.2 + 0.1 * np.tanh(z[i, 3 % latent_dim])
        tex = 30 * np.sin(freq * (xx + yy))[..., None]
        noise = rng.normal(scale=5, size=(patch_size, patch_size, 3))
        patches[i] = np.clip(base[None, None, :] + tex + noise, 0, 255).astype(np.uint8)

    return Section(
        name=name,
        expression=expression.astype(np.float32),
        positions=positions,
        centers=centers,
        patches=patches,
        counts=counts.astype(np.float32),
    )


def make_dataset(
    num_sections: int = 3,
    num_spots: int = 64,
    num_genes: int = 32,
    patch_size: int = 32,
    seed: int = 0,
) -> List[Section]:
    """Sections share gene loadings so cross-section retrieval is meaningful."""
    rng = np.random.default_rng(seed)
    loadings = rng.normal(size=(4, num_genes))
    return [
        make_section(
            f"S{i + 1}",
            num_spots=num_spots,
            num_genes=num_genes,
            patch_size=patch_size,
            seed=seed + 100 + i,
            gene_loadings=loadings,
        )
        for i in range(num_sections)
    ]


def make_spot_database(num_genes: int, num_sections: int = 32, seed: int = 5) -> List[Section]:
    """A her2st-scale retrieval database: ``num_sections`` sections of
    300-700 spots (her2st's sections span about that range), the spot side
    only: made at a 2 px patch size, the patches dropped. Sections share
    gene loadings, as in ``make_dataset``."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(300, 701, size=num_sections)
    loadings = rng.normal(size=(4, num_genes))
    return [
        dataclasses.replace(
            make_section(f"D{i + 1}", int(size), num_genes, patch_size=2,
                         seed=seed + 100 + i, gene_loadings=loadings),
            patches=None)
        for i, size in enumerate(sizes)
    ]
