"""Synthetic spatial-transcriptomics sections (NumPy).

Port of ``make_section``/``make_dataset`` of ``mclstexp_tpu/data/synthetic.py``
(same seeds, same arrays): a latent z per spot drives both the patch
texture and the counts, so image patches are predictive of expression.
``make_spot_database`` builds a her2st-scale spot-side database from them.
``write_st_layout`` writes the HER2ST on-disk layout (the JAX function's
seeds and arrays, written with the standard library, slides as PPM);
``write_visium_layout`` the 10x Visium layout that ``visium.load_visium``
reads.
"""

from __future__ import annotations

import dataclasses
import gzip
import os
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from mclstexp_tpu_torch.data.io import gzip_in_place, write_ppm
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


def write_st_layout(
    root: str,
    num_sections: int = 3,
    num_spots: Union[int, Sequence[int]] = 16,
    num_genes: int = 12,
    seed: int = 0,
) -> Tuple[List[str], List[str]]:
    """Write the HER2ST layout with synthetic data: ST-cnts/<name>.tsv (spots
    x genes, index '{x}x{y}'), ST-spotfiles/<name>_selection.tsv (x, y,
    pixel_x, pixel_y) and ST-imgs/<letter>/<name>/slide.ppm, the text as
    pandas writes it. Returns (section names, gene names).

    The same seeds and arrays as ``mclstexp_tpu.data.synthetic.
    write_st_layout`` (whose slides are JPEG); ``num_spots`` may also give
    each section its own count.
    """
    rng = np.random.default_rng(seed)
    gene_names = [f"GENE{i}" for i in range(num_genes)]
    sizes = [num_spots] * num_sections if isinstance(num_spots, int) else list(num_spots)
    if len(sizes) != num_sections:
        raise ValueError(f"{len(sizes)} spot counts for {num_sections} sections")
    names = []
    os.makedirs(os.path.join(root, "ST-cnts"), exist_ok=True)
    os.makedirs(os.path.join(root, "ST-spotfiles"), exist_ok=True)
    for s, n in enumerate(sizes):
        name = f"{chr(ord('A') + s)}1"
        names.append(name)
        side = int(np.ceil(np.sqrt(n)))
        xs, ys = np.meshgrid(np.arange(1, side + 1), np.arange(1, side + 1))
        x = xs.ravel()[:n]
        y = ys.ravel()[:n]
        counts = rng.poisson(3.0, size=(n, num_genes))
        with open(os.path.join(root, "ST-cnts", f"{name}.tsv"), "w") as f:
            f.write("\t" + "\t".join(gene_names) + "\n")
            for a, b, row in zip(x, y, counts):
                f.write(f"{a}x{b}\t" + "\t".join(map(str, row)) + "\n")
        pix = 50
        with open(os.path.join(root, "ST-spotfiles", f"{name}_selection.tsv"), "w") as f:
            f.write("x\ty\tpixel_x\tpixel_y\n")
            for a, b in zip(x.tolist(), y.tolist()):
                f.write(f"{float(a)}\t{float(b)}\t{a * pix + 25.0}\t{b * pix + 25.0}\n")
        img_dir = os.path.join(root, "ST-imgs", name[0], name)
        os.makedirs(img_dir, exist_ok=True)
        h = w = (side + 2) * pix
        write_ppm(os.path.join(img_dir, "slide.ppm"),
                  rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8))
    return names, gene_names


def write_visium_layout(
    data_root: str,
    names: Sequence[str] = ("block1", "block2"),
    num_spots: Union[int, Sequence[int]] = 40,
    num_genes: int = 12,
    side: int = 600,
    seed: int = 0,
) -> List[str]:
    """Write synthetic Visium sections in the layout of
    ``visium.visium_section_paths``: per section, the 10x triplet
    (``matrix.mtx.gz``, ``barcodes.tsv.gz``, ``features.tsv.gz``) under
    ``filtered_feature_bc_matrix`` (``filtered_count_matrix`` for the
    Alex_NatGen names), ``spatial/tissue_positions_list.csv`` (spots on a
    hexagonal grid, in shuffled order, with off-tissue barcodes that the
    barcode list leaves out) and ``image.tif``, a side x side PPM. The last
    gene repeats the first one's name (``make_var_names_unique`` renames it).
    Returns the gene names as the features file lists them."""
    import scipy.io as sio
    import scipy.sparse as sp

    from mclstexp_tpu_torch.data.visium import VISIUM_SECTIONS_ALEX

    rng = np.random.default_rng(seed)
    genes = [f"GENE{i}" for i in range(num_genes - 1)] + ["GENE0"]
    sizes = [num_spots] * len(names) if isinstance(num_spots, int) else list(num_spots)
    for name, n in zip(names, sizes):
        base = os.path.join(data_root, name)
        mdir = os.path.join(base, "filtered_count_matrix" if name in VISIUM_SECTIONS_ALEX
                            else "filtered_feature_bc_matrix")
        os.makedirs(mdir, exist_ok=True)
        os.makedirs(os.path.join(base, "spatial"), exist_ok=True)
        cols = int(np.ceil(np.sqrt(n * 1.25)))  # a quarter of the grid lies off the tissue
        step = (side - 40) // (cols + 1)
        grid = [(r, c) for r in range(cols) for c in range(cols)]
        barcodes = [f"{name}-{r:03d}-{c:03d}-1" for r, c in grid]
        on = np.sort(rng.permutation(len(grid))[:n])
        counts = rng.poisson(2.0, size=(num_genes, n))  # 10x stores genes x spots
        mtx = os.path.join(mdir, "matrix.mtx")
        sio.mmwrite(mtx, sp.coo_matrix(counts))
        gzip_in_place(mtx)
        with gzip.open(os.path.join(mdir, "barcodes.tsv.gz"), "wt") as f:
            f.write("".join(f"{barcodes[i]}\n" for i in on))
        with gzip.open(os.path.join(mdir, "features.tsv.gz"), "wt") as f:
            f.write("".join(f"ENSG{i:05d}\t{g}\tGene Expression\n" for i, g in enumerate(genes)))
        in_tissue = np.zeros(len(grid), bool)
        in_tissue[on] = True
        with open(os.path.join(base, "spatial", "tissue_positions_list.csv"), "w") as f:
            for i in rng.permutation(len(grid)):
                r, c = grid[i]
                v1, v2 = 20 + step * (r + 1), 20 + step * (c + 1) + (step // 2) * (r % 2)
                f.write(f"{barcodes[i]},{int(in_tissue[i])},{r},{c},{v1},{v2}\n")
        write_ppm(os.path.join(base, "image.tif"),
                  rng.integers(0, 256, size=(side, side, 3), dtype=np.uint8))
    return genes
