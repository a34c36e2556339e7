"""Gene-panel loading: port of ``mclstexp_tpu/data/genes.py``.

The three benchmark HVG panels ship with the reference as data
(``her_hvg_cut_1000.npy`` 785 genes, ``skin_hvg_cut_1000.npy`` 171,
``1000hvg_common.pkl`` 685). They are read from the directory that
``config.reference_data_root`` names, or from an explicit path: a ``.pkl``
is unpickled (a list, an array or a pandas Series of names), anything else
is read with ``np.load``, as the JAX package reads them.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Optional

import numpy as np

from mclstexp_tpu_torch.config import reference_data_root

_PANEL_FILES = {
    "her2st": "her_hvg_cut_1000.npy",
    "cscc": "skin_hvg_cut_1000.npy",
    "visium": "1000hvg_common.pkl",
}

PANEL_SIZES = {"her2st": 785, "cscc": 171, "visium": 685}


def load_panel(dataset: str, path: Optional[str] = None) -> List[str]:
    """Gene-name list for a benchmark dataset (or from an explicit path)."""
    if path is None:
        root = reference_data_root()
        if root is None:
            raise FileNotFoundError(
                "no gene panel path given and no reference data root found; "
                "set MCLSTEXP_REFERENCE_DATA or pass gene_panel explicitly"
            )
        path = os.path.join(root, _PANEL_FILES[dataset])
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            panel = pickle.load(f)
        return [str(g) for g in list(panel)]
    return [str(g) for g in np.load(path, allow_pickle=True)]
