"""ResNet image towers (18/50/101/152), port of ``mclstexp_tpu/models/image/resnet.py``.

torchvision's resnets with the fc head stripped and global average pooling,
as the reference builds them (``Sequential(children[:-1])``). Module names
follow torchvision inside that Sequential (``model.0`` conv1, ``model.1``
bn1, ``model.4``..``model.7`` layer1..layer4; blocks ``conv{i}``/``bn{i}``
and ``downsample.0``/``.1``), so a reference state_dict's keys load
verbatim. BatchNorm is the densenet's (``common.BatchNormT``): torch running
statistics, which the JAX ``BatchNormT`` reproduces. Output dims: 512 (r18),
2048 (the bottleneck towers).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from mclstexp_tpu_torch.core.layers import Conv2dT, as_compute, widen
from mclstexp_tpu_torch.models.image.common import (
    BatchNormT,
    global_avg_pool,
    max_pool_3x3_s2,
)


def _conv(c_in: int, c_out: int, kernel: int, stride: int = 1, device=None) -> Conv2dT:
    return Conv2dT(c_in, c_out, kernel, stride=stride, padding=kernel // 2, bias=False,
                     device=device)


def _downsample(c_in: int, c_out: int, stride: int, device=None):
    if stride == 1 and c_in == c_out:
        return None
    return nn.Sequential(_conv(c_in, c_out, 1, stride, device), BatchNormT(c_out, device))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, c_in: int, features: int, stride: int = 1, device=None):
        super().__init__()
        self.conv1 = _conv(c_in, features, 3, stride, device)
        self.bn1 = BatchNormT(features, device)
        self.conv2 = _conv(features, features, 3, 1, device)
        self.bn2 = BatchNormT(features, device)
        self.relu = nn.ReLU()
        self.downsample = _downsample(c_in, features, stride, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        identity = x if self.downsample is None else self.downsample(x)
        return self.relu(h + identity)


class Bottleneck(nn.Module):
    expansion = 4  # features is the bottleneck width; the block emits 4x

    def __init__(self, c_in: int, features: int, stride: int = 1, device=None):
        super().__init__()
        c_out = features * self.expansion
        self.conv1 = _conv(c_in, features, 1, 1, device)
        self.bn1 = BatchNormT(features, device)
        self.conv2 = _conv(features, features, 3, stride, device)
        self.bn2 = BatchNormT(features, device)
        self.conv3 = _conv(features, c_out, 1, 1, device)
        self.bn3 = BatchNormT(c_out, device)
        self.relu = nn.ReLU()
        self.downsample = _downsample(c_in, c_out, stride, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.relu(self.bn1(self.conv1(x)))
        h = self.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        identity = x if self.downsample is None else self.downsample(x)
        return self.relu(h + identity)


class ResNetEncoder(nn.Module):
    """ResNet feature tower: (B, H, W, 3) NHWC -> (B, 512 * expansion) fp32,
    computing in ``compute_dtype`` (the input cast at the entry)."""

    compute_dtype = torch.float32

    def __init__(self, stage_sizes: Sequence[int], block: str = "bottleneck", device=None):
        super().__init__()
        block_cls = Bottleneck if block == "bottleneck" else BasicBlock
        layers = [_conv(3, 64, 7, 2, device), BatchNormT(64, device), nn.ReLU(),
                  max_pool_3x3_s2()]
        c_in = 64
        for stage, num_blocks in enumerate(stage_sizes):
            features = 64 * 2**stage
            blocks = []
            for b in range(num_blocks):
                stride = 2 if (b == 0 and stage > 0) else 1
                blocks.append(block_cls(c_in, features, stride, device))
                c_in = features * block_cls.expansion
            layers.append(nn.Sequential(*blocks))
        self.model = nn.Sequential(*layers)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = as_compute(images.permute(0, 3, 1, 2), self.compute_dtype)
        return widen(global_avg_pool(self.model(x)))


def resnet18(device=None) -> ResNetEncoder:
    return ResNetEncoder((2, 2, 2, 2), "basic", device)


def resnet50(device=None) -> ResNetEncoder:
    return ResNetEncoder((3, 4, 6, 3), "bottleneck", device)


def resnet101(device=None) -> ResNetEncoder:
    return ResNetEncoder((3, 4, 23, 3), "bottleneck", device)


def resnet152(device=None) -> ResNetEncoder:
    """BLEEP's deepest resnet option."""
    return ResNetEncoder((3, 8, 36, 3), "bottleneck", device)
