"""Legacy ST-format dataset readers, HER2ST and cSCC (GSE144240): port of
``mclstexp_tpu/data/st_dataset.py`` without pandas or PIL.

The reference ingestion semantics, as the JAX package reads them:
  * counts TSV (spots x genes) indexed by '{x}x{y}' (``.tsv`` or ``.tsv.gz``);
  * spot-selection TSV with array coords (x, y) and pixel coords (pixel_x,
    pixel_y); the spot id is rebuilt from x and y rounded half to even;
  * meta = counts joined with the spots on that id: a LEFT join for HER2ST
    in count-row order (a spot id listed twice expands to two rows; a count
    row with no spot row gets NaN coordinates, which floor to -2147483648 in
    ``centers`` and ``positions``), an INNER join for cSCC;
  * expression = log-CPM over the HVG panel; patch centers = floor(pixel_x,
    pixel_y); positions = the array coords cast to int32;
  * HER2ST sections = sorted(ST-cnts)[1:33] when the listing has >= 33
    entries (smaller trees keep all); cSCC = {P2, P5, P9, P10} x {rep1..3};
  * pathologist labels for the 9 annotated HER2ST sections.

Patches are cut once per section on ``device`` by ``ops.patches.
extract_patches`` (the CUDA kernel on the card, one launch per section) into
a per-section uint8 cache: a cached file cut at another patch size is a
miss, a hit is read with ``mmap_mode="r"`` and launches nothing.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from mclstexp_tpu_torch.data.io import Table, load_slide, read_table
from mclstexp_tpu_torch.data.normalize import logcpm_panel
from mclstexp_tpu_torch.data.section import Section
from mclstexp_tpu_torch.ops.patches import extract_patches

HER2ST_LABELED_SECTIONS = ("A1", "B1", "C1", "D1", "E1", "F1", "G2", "H1", "J1")
LABEL_TO_ID = {
    "invasive cancer": 0,
    "breast glands": 1,
    "immune infiltrate": 2,
    "cancer in situ": 3,
    "connective tissue": 4,
    "adipose tissue": 5,
    "undetermined": -1,
}
CSCC_PATIENTS = ("P2", "P5", "P9", "P10")
CSCC_REPS = ("rep1", "rep2", "rep3")


def spot_ids(table: Table) -> List[str]:
    """The '{x}x{y}' id of each spot-table row, x and y rounded half to even."""
    xy = np.around(table.numeric(["x", "y"])).astype(int)
    return [f"{a}x{b}" for a, b in xy]


def rows_by_id(ids: Sequence[str]) -> Dict[str, List[int]]:
    """The rows of each id, in order."""
    out: Dict[str, List[int]] = {}
    for j, k in enumerate(ids):
        out.setdefault(k, []).append(j)
    return out


def join_rows(left_ids: Sequence[str], right_ids: Sequence[str], how: str):
    """Row pairs of ``left.join(right.set_index(id), how=how)``: left order,
    every right row of a key in its order; a left row without one is kept
    with right row -1 ("left") or dropped ("inner")."""
    if how not in ("left", "inner"):
        raise ValueError(f"how must be 'left' or 'inner', got {how!r}")
    by_id = rows_by_id(right_ids)
    left, right = [], []
    for i, k in enumerate(left_ids):
        matches = by_id.get(k, [-1] if how == "left" else [])
        left += [i] * len(matches)
        right += matches
    return np.asarray(left, np.int64), np.asarray(right, np.int64)


def _take_or_nan(values: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """values[rows] with NaN for row -1 (the left join's missing spots)."""
    out = values[np.maximum(rows, 0)]
    out[rows < 0] = np.nan
    return out


def cut_patches(slide: np.ndarray, centers: np.ndarray, patch_size: int,
                device="cuda") -> np.ndarray:
    """(N, P, P, C) uint8 patches of a host slide, cut on ``device`` by
    ``ops.patches.extract_patches`` and brought back to the host."""
    dev = torch.device(device)
    # a read-only image (PIL's) is copied: torch wants a writable array
    img = torch.from_numpy(np.require(slide, requirements=["C", "W"])).to(dev)
    xy = torch.from_numpy(np.asarray(centers, np.int64)).to(dev)
    return extract_patches(img, xy, patch_size).cpu().numpy()


def section_patches(name: str, centers: np.ndarray, slide_path: Optional[str],
                    patch_size: int, cache_dir: Optional[str], device, read_slide=load_slide):
    """The section's patches: from the cache when it holds them at this patch
    size, else cut from the slide (and cached); None without a slide."""
    cache_path = os.path.join(cache_dir, f"{name}.npy") if cache_dir is not None else None
    if cache_path is not None and os.path.exists(cache_path):
        patches = np.load(cache_path, mmap_mode="r")
        # a cache cut at a different patch size is a MISS, not a hit
        if patches.shape[1:3] == (patch_size, patch_size):
            return patches
    if slide_path is None:
        return None
    patches = cut_patches(read_slide(slide_path), centers, patch_size, device)
    if cache_path is not None:
        os.makedirs(cache_dir, exist_ok=True)
        np.save(cache_path, patches)
    return patches


def _section_from_meta(name: str, counts_all: np.ndarray, centers_xy: np.ndarray,
                       positions_xy: np.ndarray, slide_path: Optional[str], patch_size: int,
                       cache_dir: Optional[str], device, labels=None) -> Section:
    counts = counts_all.astype(np.float32)
    centers = np.floor(centers_xy).astype(np.int32)
    positions = positions_xy.astype(np.int32)
    return Section(
        name=name,
        expression=logcpm_panel(counts),
        positions=positions,
        centers=centers,
        patches=section_patches(name, centers, slide_path, patch_size, cache_dir, device),
        labels=labels,
        counts=counts,
    )


def _load_joined(name: str, cnt_path: str, pos_path: str, how: str,
                 gene_panel: Sequence[str]):
    """(meta index, panel counts, pixel (x, y), array (x, y)) of the join of
    a counts table with its spot table."""
    cnt = read_table(cnt_path, index_col=0)
    pos = read_table(pos_path)
    left, right = join_rows(cnt.index, spot_ids(pos), how)
    counts = cnt.numeric(list(gene_panel))[left]
    pixel = _take_or_nan(pos.numeric(["pixel_x", "pixel_y"]), right)
    array = _take_or_nan(pos.numeric(["x", "y"]), right)
    return [cnt.index[i] for i in left], counts, pixel, array


# ---------------------------------------------------------------- HER2ST --


def her2st_section_names(root: str) -> List[str]:
    names = sorted(os.listdir(os.path.join(root, "ST-cnts")))
    names = [n.split(".")[0][:2] for n in names]
    # The reference protocol slices sections [1:33] of the sorted listing;
    # smaller (synthetic/test) trees keep all sections.
    return names[1:33] if len(names) >= 33 else names


def her2st_cnt_path(root: str, name: str) -> str:
    """Counts TSV path, falling back to the gzipped ``.tsv.gz``."""
    path = os.path.join(root, "ST-cnts", f"{name}.tsv")
    return path if os.path.exists(path) else path + ".gz"


def cscc_cnt_path(root: str, name: str) -> str:
    """stdata TSV via glob, falling back to ``.tsv.gz``."""
    return (glob.glob(os.path.join(root, f"*{name}_stdata.tsv"))
            or glob.glob(os.path.join(root, f"*{name}_stdata.tsv.gz")))[0]


def cscc_pos_path(root: str, name: str) -> str:
    return (glob.glob(os.path.join(root, f"*spot*{name}.tsv"))
            or glob.glob(os.path.join(root, f"*spot*{name}.tsv.gz")))[0]


def her2st_slide_path(root: str, name: str) -> str:
    pre = os.path.join(root, "ST-imgs", name[0], name)
    return os.path.join(pre, os.listdir(pre)[0])


def her2st_labels(root: str, name: str, meta_index: Sequence[str]) -> Optional[np.ndarray]:
    """The annotated sections' label of each meta row (every label row of its
    id, in order; KeyError for an id with none), as an object array of str
    with NaN for an empty label."""
    if name not in HER2ST_LABELED_SECTIONS:
        return None
    path = os.path.join(root, "ST-pat", "lbl", f"{name}_labeled_coordinates.tsv")
    if not os.path.exists(path):
        return None
    table = read_table(path)
    by_id = rows_by_id(spot_ids(table))
    missing = [k for k in meta_index if k not in by_id]
    if missing:
        raise KeyError(f"{name}: spot ids without a label row: {missing[:5]}")
    labels = table.strings("label")
    return labels[[j for k in meta_index for j in by_id[k]]]


def load_her2st_section(
    root: str,
    name: str,
    gene_panel: Sequence[str],
    patch_size: int = 224,
    cache_dir: Optional[str] = None,
    with_labels: bool = False,
    with_patches: bool = True,
    device="cuda",
) -> Section:
    index, counts, pixel, array = _load_joined(
        name, her2st_cnt_path(root, name),
        os.path.join(root, "ST-spotfiles", f"{name}_selection.tsv"), "left", gene_panel)
    labels = her2st_labels(root, name, index) if with_labels else None
    slide = her2st_slide_path(root, name) if with_patches else None
    return _section_from_meta(name, counts, pixel, array, slide, patch_size, cache_dir,
                              device, labels)


def load_her2st(
    root: str,
    gene_panel: Sequence[str],
    names: Optional[Sequence[str]] = None,
    patch_size: int = 224,
    cache_dir: Optional[str] = None,
    with_labels: bool = False,
    with_patches: bool = True,
    device="cuda",
) -> List[Section]:
    if names is None:
        names = her2st_section_names(root)
    return [
        load_her2st_section(root, n, gene_panel, patch_size, cache_dir, with_labels,
                            with_patches, device)
        for n in names
    ]


# ------------------------------------------------------------------ cSCC --


def cscc_section_names() -> List[str]:
    return [f"{p}_ST_{r}" for p in CSCC_PATIENTS for r in CSCC_REPS]


def load_cscc_section(
    root: str,
    name: str,
    gene_panel: Sequence[str],
    patch_size: int = 224,
    cache_dir: Optional[str] = None,
    with_patches: bool = True,
    device="cuda",
) -> Section:
    _, counts, pixel, array = _load_joined(
        name, cscc_cnt_path(root, name), cscc_pos_path(root, name), "inner", gene_panel)
    slide = glob.glob(os.path.join(root, f"*{name}.jpg"))[0] if with_patches else None
    return _section_from_meta(name, counts, pixel, array, slide, patch_size, cache_dir,
                              device)


def load_cscc(
    root: str,
    gene_panel: Sequence[str],
    names: Optional[Sequence[str]] = None,
    patch_size: int = 224,
    cache_dir: Optional[str] = None,
    with_patches: bool = True,
    device="cuda",
) -> List[Section]:
    if names is None:
        names = cscc_section_names()
    return [
        load_cscc_section(root, n, gene_panel, patch_size, cache_dir, with_patches, device)
        for n in names
    ]
