"""Reference-trained baseline checkpoints -> the port's baseline models.

Port of ``mclstexp_tpu/baselines/torch_import.py``. The reference trains its
comparison baselines with Lightning or plain torch and saves either a bare
``state_dict`` (``BLEEP_main.py:179-186``) or a Lightning ``.ckpt``, a dict
whose ``state_dict`` entry holds the module's tensors under ``model.``
(``HIST2ST_train.py:98``, HisToGene tutorial cell 3). The JAX package maps
those tensors onto flax trees; the port's four baseline modules carry the
reference's own torch keys, so the tensors load as they are, with
``strict=True``: a missing or unconsumed tensor raises, as JAX's importers
raise.

* HisToGene, Hist2ST, THItoGene: the keys of the reference modules
  (``patch_embedding``, ``x_embed``/``y_embed``, ``vit.transformer.…``,
  ``gene_head.…``; Hist2ST's ``jknet`` LSTM, ``mean``/``disp``/``pi`` or
  ``hr``/``hp``, ``coef``; THItoGene's ``odconv2d``, ``caps_layer``,
  ``gat``). Hist2ST's LSTM has torch's two bias vectors per layer, and a
  reference checkpoint carries a nonzero ``bias_hh``. JAX sums ``bias_ih +
  bias_hh`` into flax's one hidden-side bias; the port's ``nn.LSTM`` keeps
  both, so loading them as they are gives the same sum and the same forward
  (its ``bias_hh`` is a fixed buffer that training leaves, the JAX rule).
* BLEEP: ``image_encoder.model.*`` is a timm tower (``Bleep/modules.py:
  7-132``) and the two projection heads. The heads' keys are the port's.
  The tower's are not always: the port's resnets number the trunk as the
  reference mclSTExp's ``Sequential`` (``0/1/4..7``) where timm names
  ``conv1/bn1/layer1..4``, and the port's ViT blocks are its ``AttnBlock``
  where timm has ``norm1/attn.qkv/…``. The tower goes through
  ``models/image/torch_import.import_image_tower``, which takes either
  naming (JAX's ``import_image_tower`` takes the same two) and checks the
  tower strictly. A tower without a reference layout (``tiny_cnn``)
  raises ``NotImplementedError``, as in JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from mclstexp_tpu_torch.models.image.torch_import import import_image_tower

FAMILIES = ("histogene", "hist2st", "thitogene", "bleep")
BLEEP_TOWER = "image_encoder.model."


def read_baseline_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a reference ``.pt`` state_dict or Lightning ``.ckpt``
    on the CPU, keys without ``module.`` (DataParallel) and a leading
    ``model.`` (Lightning's module attribute)."""
    try:
        raw = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:  # a Lightning ckpt may pickle non-tensor metadata
        raw = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(raw.get("state_dict", None), dict):
        raw = raw["state_dict"]
    sd = {}
    for key, value in raw.items():
        key = key.replace("module.", "")
        if key.startswith("model."):
            key = key[len("model."):]
        sd[key] = value if torch.is_tensor(value) else torch.as_tensor(np.asarray(value))
    return sd


def bleep_state_dict(sd: Dict[str, torch.Tensor], encoder_name: str) -> Dict[str, torch.Tensor]:
    """A reference BLEEP state_dict -> the port's ``BLEEP`` keys: the tower's
    timm (or ``Sequential``) names -> the port's tower, the heads as they
    are."""
    tower = import_image_tower({k: v for k, v in sd.items() if k.startswith(BLEEP_TOWER)},
                               encoder_name)
    out = {f"image_encoder.{k}": v for k, v in tower.items()}
    out.update((k, v) for k, v in sd.items() if not k.startswith(BLEEP_TOWER))
    return out


def load_baseline_torch_checkpoint(path: str, family: str, model: nn.Module) -> nn.Module:
    """Load a reference-trained ``family`` checkpoint into ``model`` in place,
    onto the model's device, strictly; returns the model."""
    if family not in FAMILIES:
        raise KeyError(f"unknown baseline {family!r}; have {list(FAMILIES)}")
    sd = read_baseline_checkpoint(path)
    if family == "bleep":
        sd = bleep_state_dict(sd, model.encoder_name)
    model.load_state_dict(sd, strict=True)
    return model
