"""Gene-panel selection: per-section HVG masks -> union/intersection -> panel.
Port of ``mclstexp_tpu/data/panel.py``.

Per section, scanpy's ``normalize_total -> log1p -> highly_variable_genes
(n_top)`` over the genes every section shares, then union/intersection
bookkeeping, and the JAX package's deterministic cut:

  * rank shared genes by (#sections selecting them as HVG, mean normalized
    dispersion), both descending;
  * keep genes selected by at least ``min_sections`` sections (default 1 ==
    the union), then truncate to ``panel_size`` if given.

Artifacts written by ``save_panel_artifacts``, in the JAX package's layout
(each package reads the other's):

  per_section_hvg.npz       bool masks (S, G_shared) + gene/section names
  hvgs_union.pickle         bool pandas Series indexed by gene when pandas
  hvgs_intersection.pickle  imports, else the bool array
  <dataset>_hvg_panel.npy   object array of panel gene names (``genes.load_panel``)
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import List, Optional, Sequence

import numpy as np

from mclstexp_tpu_torch.data.hvg import (
    hvg_mask_from_dispersion,
    hvg_union_intersection,
    seurat_dispersion,
)
from mclstexp_tpu_torch.data.io import read_table
from mclstexp_tpu_torch.data.normalize import log1p, normalize_total
from mclstexp_tpu_torch.data.st_dataset import (
    cscc_cnt_path,
    cscc_section_names,
    her2st_cnt_path,
    her2st_section_names,
)
from mclstexp_tpu_torch.data.visium import make_var_names_unique, read_10x_mtx


@dataclasses.dataclass(frozen=True)
class CountFrame:
    """One section's raw counts with gene names (pre-panel)."""

    name: str
    genes: List[str]
    counts: np.ndarray  # (N_spots, G) raw counts


@dataclasses.dataclass(frozen=True)
class PanelSelection:
    section_names: List[str]
    shared_genes: List[str]  # genes present in every section, stable order
    masks: np.ndarray  # (S, G_shared) bool per-section HVG masks
    union: np.ndarray  # (G_shared,) bool
    intersection: np.ndarray  # (G_shared,) bool
    n_selected: np.ndarray  # (G_shared,) int: #sections selecting each gene
    mean_dispersion: np.ndarray  # (G_shared,) mean normalized dispersion
    panel: List[str]  # the cut panel gene names


def shared_gene_order(frames: Sequence[CountFrame]) -> List[str]:
    """Genes present in every section, in the first section's column order."""
    shared = set(frames[0].genes)
    for f in frames[1:]:
        shared &= set(f.genes)
    return [g for g in frames[0].genes if g in shared]


def select_panel(
    frames: Sequence[CountFrame],
    n_top_genes: int = 1000,
    min_sections: int = 1,
    panel_size: Optional[int] = None,
) -> PanelSelection:
    """The per-section HVG flow plus the cut rule above."""
    if not frames:
        raise ValueError("no count frames given")
    shared = shared_gene_order(frames)
    if not shared:
        raise ValueError("sections share no genes")
    masks, disps = [], []
    for f in frames:
        col = {g: i for i, g in enumerate(f.genes)}
        counts = np.asarray(f.counts, dtype=np.float64)[:, [col[g] for g in shared]]
        # one dispersion pass per section feeds both the mask and the ranking
        _, disp_norm = seurat_dispersion(log1p(normalize_total(counts)))
        masks.append(hvg_mask_from_dispersion(disp_norm, n_top_genes))
        disps.append(disp_norm)
    masks = np.asarray(masks)
    union, intersection = hvg_union_intersection(masks)
    n_selected = masks.sum(axis=0).astype(np.int64)
    disp_arr = np.asarray(disps)
    finite = np.isfinite(disp_arr)
    mean_disp = np.where(
        finite.any(axis=0),
        np.where(finite, disp_arr, 0.0).sum(axis=0) / np.maximum(finite.sum(axis=0), 1),
        -np.inf,
    )

    keep = n_selected >= max(1, min_sections)
    order = np.lexsort((-mean_disp, -n_selected))  # freq desc, then disp desc
    ranked = [i for i in order if keep[i]]
    if panel_size is not None:
        ranked = ranked[:panel_size]

    return PanelSelection(
        section_names=[f.name for f in frames],
        shared_genes=shared,
        masks=masks,
        union=union,
        intersection=intersection,
        n_selected=n_selected,
        mean_dispersion=mean_disp,
        panel=[shared[i] for i in ranked],
    )


def save_panel_artifacts(sel: PanelSelection, out_dir: str, dataset: str) -> str:
    """Write the artifact set; returns the panel .npy path."""
    os.makedirs(out_dir, exist_ok=True)
    np.savez(
        os.path.join(out_dir, "per_section_hvg.npz"),
        masks=sel.masks,
        genes=np.asarray(sel.shared_genes, dtype=object),
        sections=np.asarray(sel.section_names, dtype=object),
        n_selected=sel.n_selected,
        mean_dispersion=sel.mean_dispersion,
    )
    try:
        import pandas as pd

        union, inter = (pd.Series(sel.union, index=sel.shared_genes),
                        pd.Series(sel.intersection, index=sel.shared_genes))
    except ImportError:  # the card's machine has no pandas: the plain arrays
        union, inter = sel.union, sel.intersection
    for fname, obj in (("hvgs_union.pickle", union), ("hvgs_intersection.pickle", inter)):
        with open(os.path.join(out_dir, fname), "wb") as f:
            pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)
    panel_path = os.path.join(out_dir, f"{dataset}_hvg_panel.npy")
    np.save(panel_path, np.asarray(sel.panel, dtype=object), allow_pickle=True)
    return panel_path


# ------------------------------------------------- raw count-frame loaders


def _tsv_frame(name: str, path: str) -> CountFrame:
    cnt = read_table(path, index_col=0)
    return CountFrame(name, list(cnt.columns), cnt.numeric().astype(np.float32))


def her2st_count_frames(root: str) -> List[CountFrame]:
    """Full (pre-panel) count tables in the protocol's section order
    (sorted(ST-cnts)[1:33]), ``.tsv`` or ``.tsv.gz``."""
    return [_tsv_frame(n, her2st_cnt_path(root, n)) for n in her2st_section_names(root)]


def cscc_count_frames(root: str) -> List[CountFrame]:
    """cSCC count tables (the stdata TSVs the dataset reader uses)."""
    return [_tsv_frame(n, cscc_cnt_path(root, n)) for n in cscc_section_names()]


def visium_count_frames(matrix_dirs: dict) -> List[CountFrame]:
    """10x mtx count frames ({section: matrix_dir})."""
    out = []
    for name, d in matrix_dirs.items():
        mat, _barcodes, gene_names = read_10x_mtx(d)  # (spots, genes)
        genes = make_var_names_unique(gene_names)
        out.append(CountFrame(name, [str(g) for g in genes], mat.astype(np.float32)))
    return out


def count_frames_for_dataset(dataset: str, data_root: str) -> List[CountFrame]:
    if dataset == "her2st":
        return her2st_count_frames(data_root)
    if dataset == "cscc":
        return cscc_count_frames(data_root)
    raise ValueError(
        f"panel selection for dataset {dataset!r} needs explicit count "
        "frames (visium: pass matrix dirs via visium_count_frames)"
    )
