"""The port's model -> the reference torch ``state_dict`` layout.

Port of ``mclstexp_tpu/models/image/torch_export.py``: a model trained here
becomes the ``state_dict`` the reference's ``mclSTExp_Attention`` (or
``mclSTExp_MLP``, with its ``image_ecode`` attribute) loads with
``strict=True``, so the reference's eval scripts score it unchanged. The
inverse of ``torch_import.import_reference_state_dict``:
  * the ViT towers' keys go back to timm's names (``fc_norm`` for the final
    norm, ``norm`` on the CLIP trunks);
  * the position tables are padded with zero rows to the reference's
    ``nn.Embedding(65536, d)`` (``pos_rows``), or scattered back to their
    raw-coordinate rows through a ``PosRemap``; the zero rows are never read
    by the dataset the model was trained on;
  * ``num_batches_tracked`` is written as 0, as the JAX exporter writes it
    (it only feeds torch's cumulative-average BatchNorm mode, which the
    reference never uses).
Every other tensor is the model's own, bit for bit. The export is always
imported back and compared with the model's tensors before it is returned. ``tiny_cnn`` and ``tiny_densenet`` have no reference layout and
raise.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from mclstexp_tpu_torch.config import ModelConfig
from mclstexp_tpu_torch.data.posremap import REFERENCE_POS_ROWS
from mclstexp_tpu_torch.models.image.torch_import import (
    VITS,
    _check_reference_tower,
    import_reference_state_dict,
    vit_key_to_timm,
)


def _pad_pos_table(table: torch.Tensor, pos_rows: int) -> torch.Tensor:
    if table.shape[0] >= pos_rows:
        return table
    return torch.cat([table, table.new_zeros(pos_rows - table.shape[0], table.shape[1])])


def export_reference_state_dict(sd: Dict[str, torch.Tensor], cfg: ModelConfig,
                                pos_rows: int = REFERENCE_POS_ROWS,
                                pos_remap=None) -> Dict[str, torch.Tensor]:
    """The state_dict of the port's ``MclSTExp(cfg)`` -> the reference's
    layout, on the CPU."""
    _check_reference_tower(cfg.encoder_name)
    tower = "image_encoder" if cfg.variant == "attention" else "image_ecode"
    pre_norm = any(k.startswith(f"{tower}.model.norm_pre.") for k in sd)
    out: Dict[str, torch.Tensor] = {}
    for key, value in sd.items():
        value = value.detach().to("cpu", copy=True)
        if key.startswith(f"{tower}.model.") and cfg.encoder_name in VITS:
            key = f"{tower}.model." + vit_key_to_timm(key[len(f"{tower}.model."):], pre_norm)
        if key.endswith("num_batches_tracked"):
            value = torch.zeros((), dtype=torch.int64)
        elif key in ("x_embed.weight", "y_embed.weight"):
            if pos_remap is not None:
                scatter = pos_remap.scatter_x if key[0] == "x" else pos_remap.scatter_y
                value = torch.from_numpy(scatter(value.numpy(), pos_rows))
            else:
                value = _pad_pos_table(value, pos_rows)
        out[key] = value
    _verify_roundtrip(out, sd, cfg, pos_remap)
    return out


def _verify_roundtrip(exported, sd, cfg: ModelConfig, pos_remap=None) -> None:
    # the model's table rows (a remapped preset's vocab is the remap's)
    cfg = dataclasses.replace(cfg, pos_vocab=sd["x_embed.weight"].shape[0])
    back = import_reference_state_dict(exported, cfg, pos_remap=pos_remap)
    if back.keys() != sd.keys():
        raise AssertionError("export roundtrip changed the key set")
    for key, got in back.items():
        want = sd[key].detach().cpu()
        if key.endswith("num_batches_tracked"):
            continue
        if pos_remap is not None and key in ("x_embed.weight", "y_embed.weight"):
            # the compact table's padding rows scatter to nowhere and come
            # back as zeros: compare the observed rows
            n = len(pos_remap.x_values if key[0] == "x" else pos_remap.y_values)
            got, want = got[:n], want[:n]
        if not torch.equal(got, want):
            raise AssertionError(f"export roundtrip mismatch at {key}")


def save_reference_checkpoint(path: str, sd: Dict[str, torch.Tensor], cfg: ModelConfig,
                              pos_rows: int = REFERENCE_POS_ROWS, pos_remap=None) -> str:
    """``torch.save`` the reference-layout ``state_dict`` of ``sd`` to
    ``path``, the file the reference's eval scripts load; returns the path."""
    torch.save(export_reference_state_dict(sd, cfg, pos_rows, pos_remap), path)
    return path
