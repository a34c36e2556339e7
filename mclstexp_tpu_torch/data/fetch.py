"""Dataset acquisition: fresh machine -> `cli hvg` -> `cli train`.

Port of ``mclstexp_tpu/data/fetch.py``. ``cli fetch <dataset> --dest <dir>``
clones HER2ST (the reference's one-line fetcher), pulls the cSCC GEO
supplementary tar, or prints the (login-gated) Visium sources, then says
which ``--data-root`` to pass to the port's CLI next. ``--dry-run`` prints
the commands without running them. The loaders read ``.tsv.gz`` counts, so
the archives work as fetched.
"""

from __future__ import annotations

import os
import subprocess
from typing import List

HER2ST_GIT = "https://github.com/almaan/her2st.git"  # the reference's data/download.sh
# GEO supplementary archive for GSE144240 (Ji et al. cSCC; reference
# dataset.py:23 reads its extracted GSM*_P*_ST_rep* files).
CSCC_TAR_URL = (
    "https://ftp.ncbi.nlm.nih.gov/geo/series/GSE144nnn/GSE144240/suppl/"
    "GSE144240_RAW.tar"
)

VISIUM_SOURCES = """\
The 9 Visium sections (reference train.py:63-76) come from two places:
  * Alex_NatGen sections 1142243F, 1160920F, CID4290, CID4465, CID44971,
    CID4535 — Wu et al. 2021 (Nat Genet), GEO GSE176078 / Zenodo record
    4739739 ("Spatial Transcriptomics" archives; per-section image.tif,
    spatial/tissue_positions_list.csv, filtered_count_matrix/).
  * 10x Genomics demo sections block1, block2 (V1_Breast_Cancer_Block_A
    sections 1/2) and FFPE (Visium_FFPE_Human_Breast_Cancer) —
    https://www.10xgenomics.com/datasets (spatial imaging data +
    filtered_feature_bc_matrix).
Arrange each section under <dest>/visium/<name>/ as documented in
docs/MIGRATION.md, then run:
  python -m mclstexp_tpu_torch.cli hvg  --dataset visium --data-root <dest>/visium
  python -m mclstexp_tpu_torch.cli train --dataset visium --data-root <dest>/visium
"""


def fetch_commands(dataset: str, dest: str) -> List[List[str]]:
    """The shell commands `fetch` runs (empty for instruction-only sets)."""
    if dataset == "her2st":
        return [["git", "clone", HER2ST_GIT, os.path.join(dest, "her2st")]]
    if dataset == "cscc":
        raw = os.path.join(dest, "GSE144240_RAW")
        tar = os.path.join(raw, "GSE144240_RAW.tar")
        return [
            ["curl", "-L", "--fail", "--create-dirs", "-o", tar, CSCC_TAR_URL],
            ["tar", "-xf", tar, "-C", raw],
        ]
    if dataset == "visium":
        return []
    raise ValueError(f"unknown dataset {dataset!r}; expected her2st/cscc/visium")


def next_steps(dataset: str, dest: str) -> str:
    if dataset == "her2st":
        root = os.path.join(dest, "her2st", "data")
        return (
            f"HER2ST cloned. Unpack any archives so {root} holds ST-cnts/, "
            f"ST-spotfiles/, ST-imgs/, ST-pat/ (see docs/MIGRATION.md), then:\n"
            f"  python -m mclstexp_tpu_torch.cli hvg   --dataset her2st --data-root {root}\n"
            f"  python -m mclstexp_tpu_torch.cli train --dataset her2st --data-root {root}"
        )
    if dataset == "cscc":
        root = os.path.join(dest, "GSE144240_RAW")
        return (
            f"GSE144240 extracted to {root} (GSM*_P*_ST_rep* stdata/spot/jpg "
            f"triplets; .tsv.gz is fine — the loaders read it directly):\n"
            f"  python -m mclstexp_tpu_torch.cli hvg   --dataset cscc --data-root {root}\n"
            f"  python -m mclstexp_tpu_torch.cli train --dataset cscc --data-root {root}"
        )
    return VISIUM_SOURCES


def fetch(dataset: str, dest: str, dry_run: bool = False) -> int:
    cmds = fetch_commands(dataset, dest)
    if not cmds:
        print(next_steps(dataset, dest))
        return 0
    for cmd in cmds:
        print("+ " + " ".join(cmd))
        if dry_run:
            continue
        os.makedirs(dest, exist_ok=True)
        rc = subprocess.call(cmd)
        if rc != 0:
            print(f"fetch step failed (exit {rc}): {' '.join(cmd)}")
            return rc
    print(next_steps(dataset, dest))
    return 0
