"""Super-resolution prediction: a dense grid of patch centers over a section,
and the expression a slide model predicts there (HisToGene's SR mode,
reference ``baselines/HisToGene/dataset.py:304-338`` + ``predict.py:46-68``).

Port of ``mclstexp_tpu/baselines/super_resolution.py``. The grid steps 56 px
across the bounding box of the section's spot centers; each grid center's
array position is ``center // r``, r = max((max - min) // 30, 1) per axis
(the JAX formula, which divides the raw coordinate, not its offset from the
box), clipped to the 64-entry position tables. The grid's patches are cut
by ``data/st_dataset.cut_patches`` on the model's device: the
extract_patches kernel on the card, bit-equal to JAX's ``extract_patches_np``
for every patch size. The grid is predicted as one slide, as JAX predicts
it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from mclstexp_tpu_torch.baselines.trainer import predict_slide
from mclstexp_tpu_torch.data.section import Section
from mclstexp_tpu_torch.data.st_dataset import cut_patches


def sr_grid(centers: np.ndarray, step: int = 56,
            n_bins: int = 30) -> Tuple[np.ndarray, np.ndarray]:
    """(grid centers (M, 2), grid positions (M, 2)), int32, over the spot
    centers' bounding box, x fastest."""
    centers = np.asarray(centers)
    min_x, max_x = int(centers[:, 0].min()), int(centers[:, 0].max())
    min_y, max_y = int(centers[:, 1].min()), int(centers[:, 1].max())
    r_x = max((max_x - min_x) // n_bins, 1)
    r_y = max((max_y - min_y) // n_bins, 1)
    gx, gy = np.meshgrid(np.arange(min_x, max_x, step), np.arange(min_y, max_y, step))
    grid_centers = np.stack([gx.ravel(), gy.ravel()], axis=1).astype(np.int32)
    grid_positions = np.stack([grid_centers[:, 0] // r_x, grid_centers[:, 1] // r_y],
                              axis=1).astype(np.int32)
    return grid_centers, grid_positions


def sr_section(section: Section, slide: np.ndarray, patch_size: int = 112,
               device="cuda") -> Section:
    """A Section over ``section``'s SR grid, named ``<name>_sr``: zero
    expression, positions clipped to 0..63, the grid's patches cut from the
    host ``slide`` on ``device``."""
    grid_centers, grid_positions = sr_grid(section.centers)
    m = len(grid_centers)
    return Section(
        name=f"{section.name}_sr",
        expression=np.zeros((m, section.num_genes), np.float32),
        positions=np.clip(grid_positions, 0, 63),
        centers=grid_centers,
        patches=cut_patches(slide, grid_centers, patch_size, device),
    )


def sr_predict(model, section: Section, slide: np.ndarray,
               cfg) -> Tuple[np.ndarray, np.ndarray]:
    """(predictions (M, G), grid centers (M, 2)) of a slide model on
    ``section``'s SR grid; the patches are cut on the model's device."""
    device = next(model.parameters()).device
    sr_sec = sr_section(section, slide, cfg.patch_size, device)
    return predict_slide(model, sr_sec, cfg), sr_sec.centers
