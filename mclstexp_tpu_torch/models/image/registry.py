"""Image-tower registry: encoder_name -> (nn.Module, feature dim).

Port of ``mclstexp_tpu/models/image/registry.py`` for the towers ported so
far; the others are queued in ROADMAP.md.
"""

from __future__ import annotations

from typing import Tuple

from torch import nn

from mclstexp_tpu_torch.models.image.densenet import densenet121, tiny_densenet

ENCODERS = {
    "densenet121": (densenet121, 1024),
    "tiny_densenet": (tiny_densenet, 16),  # test tower: densenet code paths
}


def build_encoder(name: str, device=None) -> Tuple[nn.Module, int]:
    if name not in ENCODERS:
        raise KeyError(f"unknown image encoder {name!r}; have {sorted(ENCODERS)}")
    factory, dim = ENCODERS[name]
    return factory(device=device), dim
