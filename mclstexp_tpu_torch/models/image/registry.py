"""Image-tower registry: encoder_name -> (nn.Module, feature dim).

Port of ``mclstexp_tpu/models/image/registry.py``: the reference's encoder
names (``densenet121``, the resnets, the ViTs; BLEEP's wider menu) at the
same dims, and the two test towers.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from mclstexp_tpu_torch.core.layers import set_compute_dtype

from mclstexp_tpu_torch.models.image.densenet import densenet121, tiny_densenet
from mclstexp_tpu_torch.models.image.resnet import resnet18, resnet50, resnet101, resnet152
from mclstexp_tpu_torch.models.image.vit import clip_vit_b32, tiny_cnn, vit_b32, vit_l32

ENCODERS = {
    "densenet121": (densenet121, 1024),
    "resnet50": (resnet50, 2048),
    "res101": (resnet101, 2048),
    "res18": (resnet18, 512),
    "vit": (vit_b32, 768),
    "resnet152": (resnet152, 2048),
    "vit_l": (vit_l32, 1024),
    "clip_vit": (clip_vit_b32, 768),
    "tiny_cnn": (tiny_cnn, 128),
    "tiny_densenet": (tiny_densenet, 16),  # test tower: densenet code paths
}


def build_encoder(name: str, device=None,
                  dtype: torch.dtype = torch.float32) -> Tuple[nn.Module, int]:
    """(tower, feature dim): fp32 parameters, computing in ``dtype``, fp32
    features out (JAX ``registry.build_encoder(name, dtype=...)``)."""
    if name not in ENCODERS:
        raise KeyError(f"unknown image encoder {name!r}; have {sorted(ENCODERS)}")
    factory, dim = ENCODERS[name]
    return set_compute_dtype(factory(device=device), dtype), dim
