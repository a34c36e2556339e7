"""10x Visium dataset reader (Swarbrick Alex_NatGen + 10xGenomics sections):
port of ``mclstexp_tpu/data/visium.py`` without pandas.

The reference's TenxDataset semantics:
  * per-barcode pixel coords from ``tissue_positions_list.csv`` (no header)
    columns 4/5 (pixel row v1, pixel col v2), for the barcodes of
    ``barcodes.tsv(.gz)`` in their order;
  * expression from a precomputed ``preprocessed_matrix.npy`` (genes x
    spots, transposed to spots x genes);
  * patches cut around (x, y) = (v2, v1); positions = (v1, v2), the raw pixel
    coords (``posremap.PosRemap`` maps them to dense table rows);
  * the image in OpenCV's BGR channel order, as ``cv2.imread`` gives it: a
    binary PPM is read natively and channel-reversed, any other format goes
    through ``cv2`` (imported when needed).

``build_visium_preprocessed`` makes the preprocessed matrices from the 10x
mtx triplets (scipy's ``mmread``).
"""

from __future__ import annotations

import gzip
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from mclstexp_tpu_torch.data.io import Table, open_text, read_ppm, read_table
from mclstexp_tpu_torch.data.normalize import library_size_normalize, log_transform
from mclstexp_tpu_torch.data.section import Section
from mclstexp_tpu_torch.data.st_dataset import rows_by_id, section_patches

VISIUM_SECTIONS_ALEX = ("1142243F", "CID4290", "CID4465", "CID44971", "CID4535", "1160920F")
VISIUM_SECTIONS_10X = ("block1", "block2", "FFPE")
VISIUM_SECTIONS = VISIUM_SECTIONS_ALEX + VISIUM_SECTIONS_10X


def read_barcodes(path: str) -> List[str]:
    with open_text(path) as f:
        return [line.strip().split("\t")[0] for line in f if line.strip()]


def read_tissue_positions(path: str) -> Table:
    """The headerless positions CSV; columns are named "0" to "5"."""
    return read_table(path, sep=",", header=False)


def load_bgr(path: str) -> np.ndarray:
    """(H, W, 3) uint8 image in BGR order, as ``cv2.imread`` reads it."""
    rgb = read_ppm(path)
    if rgb is not None:
        return np.ascontiguousarray(rgb[..., ::-1])
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"reading {os.path.basename(path)} needs OpenCV (cv2): only "
                          "binary PPM images are read without it") from e
    os.environ.setdefault("OPENCV_IO_MAX_IMAGE_PIXELS", str(2**40))
    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return img


def load_visium_section(
    name: str,
    image_path: str,
    spatial_pos_path: str,
    barcode_path: str,
    reduced_mtx_path: str,
    patch_size: int = 224,
    cache_dir: Optional[str] = None,
    with_patches: bool = True,
    device="cuda",
) -> Section:
    barcodes = read_barcodes(barcode_path)
    pos = read_tissue_positions(spatial_pos_path)
    by_barcode = rows_by_id(pos.strings("0"))
    missing = [b for b in barcodes if b not in by_barcode]
    if missing:
        raise KeyError(f"{name}: barcodes without a tissue position: {missing[:5]}")
    rows = [j for b in barcodes for j in by_barcode[b]]
    v1, v2 = pos.numeric(["4", "5"])[rows].astype(np.int64).T
    positions = np.stack([v1, v2], axis=1).astype(np.int32)  # (v1, v2)
    centers = np.stack([v2, v1], axis=1).astype(np.int32)  # patch center (x, y)

    expression = np.load(reduced_mtx_path).T.astype(np.float32)  # spots x genes
    if len(expression) != len(barcodes):
        raise ValueError(
            f"{name}: {len(barcodes)} barcodes but {len(expression)} expression rows"
        )
    patches = None
    if with_patches:
        patches = section_patches(name, centers, image_path, patch_size, cache_dir, device,
                                  read_slide=load_bgr)
    return Section(
        name=name,
        expression=expression,
        positions=positions,
        centers=centers,
        patches=patches,
    )


def visium_section_paths(data_root: str, preprocessed_root: str, name: str) -> dict:
    """Standard layout: <data_root>/<name>/{image.tif, spatial/..., *count_matrix/...}."""
    base = os.path.join(data_root, name)
    bc_dir = (
        "filtered_count_matrix" if name in VISIUM_SECTIONS_ALEX else "filtered_feature_bc_matrix"
    )
    return dict(
        name=name,
        image_path=os.path.join(base, "image.tif"),
        spatial_pos_path=os.path.join(base, "spatial", "tissue_positions_list.csv"),
        barcode_path=os.path.join(base, bc_dir, "barcodes.tsv.gz"),
        reduced_mtx_path=os.path.join(preprocessed_root, name, "preprocessed_matrix.npy"),
    )


def load_visium(
    data_root: str,
    preprocessed_root: str,
    names: Sequence[str] = VISIUM_SECTIONS,
    patch_size: int = 224,
    cache_dir: Optional[str] = None,
    with_patches: bool = True,
    device="cuda",
) -> List[Section]:
    return [
        load_visium_section(patch_size=patch_size, cache_dir=cache_dir,
                            with_patches=with_patches, device=device,
                            **visium_section_paths(data_root, preprocessed_root, name))
        for name in names
    ]


def make_var_names_unique(names: Sequence[str]) -> List[str]:
    """scanpy ``var_names_make_unique`` semantics: duplicates get -1, -2, ..."""
    seen: dict = {}
    out = []
    for n in names:
        if n in seen:
            seen[n] += 1
            out.append(f"{n}-{seen[n]}")
        else:
            seen[n] = 0
            out.append(n)
    return out


def build_visium_preprocessed(matrix_dirs: dict, out_root: str,
                              gene_list: Sequence[str]) -> None:
    """Per-section ``preprocessed_matrix.npy`` (genes x spots) for Visium.

    matrix_dirs: {section name: path to the 10x mtx triplet directory}. The
    reference's quirk is kept: the matrices are normalized gene x spot, so
    each GENE row is L1-normalized across spots, then log10(1 + x).
    """
    for name, mdir in matrix_dirs.items():
        mat, _, gene_names = read_10x_mtx(mdir)  # (spots, genes)
        col = {g: i for i, g in enumerate(make_var_names_unique(gene_names))}
        sub = mat[:, [col[g] for g in gene_list]].T.astype(np.float64)  # gene x spot
        d = os.path.join(out_root, name)
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, "preprocessed_matrix.npy"),
                log_transform(library_size_normalize(sub)))


def read_10x_mtx(matrix_dir: str) -> Tuple[np.ndarray, List[str], List[str]]:
    """A 10x mtx triplet (matrix.mtx(.gz), barcodes, features) as a dense
    (spots x genes) array, the barcodes and the gene names."""
    import scipy.io as sio

    def find(prefixes):
        for p in prefixes:
            full = os.path.join(matrix_dir, p)
            if os.path.exists(full):
                return full
        raise FileNotFoundError(f"none of {prefixes} under {matrix_dir}")

    mtx_path = find(["matrix.mtx.gz", "matrix.mtx"])
    bc_path = find(["barcodes.tsv.gz", "barcodes.tsv"])
    feat_path = find(["features.tsv.gz", "features.tsv", "genes.tsv.gz", "genes.tsv"])

    if mtx_path.endswith(".gz"):
        with gzip.open(mtx_path, "rb") as f:
            mat = sio.mmread(f)
    else:
        mat = sio.mmread(mtx_path)
    mat = np.asarray(mat.todense()).T  # 10x stores genes x cells
    barcodes = read_barcodes(bc_path)
    with open_text(feat_path) as f:
        rows = [line.strip().split("\t") for line in f if line.strip()]
    gene_names = [r[1] if len(r) > 1 else r[0] for r in rows]
    return mat, barcodes, gene_names
