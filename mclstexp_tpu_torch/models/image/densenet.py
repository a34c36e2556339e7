"""DenseNet image towers, port of ``mclstexp_tpu/models/image/densenet.py``.

The reference's default image encoder is torchvision ``densenet121`` with
the classifier stripped: the ``features`` trunk ending at ``norm5``, then
adaptive average pooling. There is **no ReLU after norm5** (torchvision's
own ``forward`` adds one; the reference's ``Sequential(children[:-1])``
bypasses it). Module names follow torchvision, and the trunk sits at
``model.0`` as in the reference's ``ImageEncoder``, so reference keys such
as ``model.0.denseblock1.denselayer1.conv1.weight`` load verbatim.

Dense connectivity is the plain concat form. The JAX build's piecewise
forms have the same parameters and change only TPU memory traffic.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Sequence

import torch
from torch import nn

from mclstexp_tpu_torch.models.image.common import (
    BatchNormT,
    global_avg_pool,
    max_pool_3x3_s2,
)


class DenseLayer(nn.Module):
    """BN-ReLU-Conv1x1(bn_size*k)-BN-ReLU-Conv3x3(k) over the concat input."""

    def __init__(self, in_features: int, growth_rate: int, bn_size: int, device=None):
        super().__init__()
        self.norm1 = BatchNormT(in_features, device)
        self.relu1 = nn.ReLU()
        self.conv1 = nn.Conv2d(in_features, bn_size * growth_rate, 1, bias=False, device=device)
        self.norm2 = BatchNormT(bn_size * growth_rate, device)
        self.relu2 = nn.ReLU()
        self.conv2 = nn.Conv2d(bn_size * growth_rate, growth_rate, 3, padding=1,
                               bias=False, device=device)

    def forward(self, features: List[torch.Tensor]) -> torch.Tensor:
        h = torch.cat(features, dim=1)
        h = self.conv1(self.relu1(self.norm1(h)))
        return self.conv2(self.relu2(self.norm2(h)))


class DenseBlock(nn.ModuleDict):
    def __init__(self, num_layers: int, in_features: int, growth_rate: int,
                 bn_size: int, device=None):
        super().__init__()
        for i in range(num_layers):
            self[f"denselayer{i + 1}"] = DenseLayer(
                in_features + i * growth_rate, growth_rate, bn_size, device
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        features = [x]
        for layer in self.values():
            features.append(layer(features))
        return torch.cat(features, dim=1)


class Transition(nn.Sequential):
    def __init__(self, in_features: int, out_features: int, device=None):
        super().__init__(OrderedDict(
            norm=BatchNormT(in_features, device),
            relu=nn.ReLU(),
            conv=nn.Conv2d(in_features, out_features, 1, bias=False, device=device),
            pool=nn.AvgPool2d(2, stride=2),
        ))


def densenet_features(
    block_config: Sequence[int], growth_rate: int, bn_size: int,
    init_features: int, device=None,
) -> nn.Sequential:
    """The torchvision ``features`` trunk, conv0 through norm5."""
    layers = OrderedDict(
        conv0=nn.Conv2d(3, init_features, 7, stride=2, padding=3, bias=False, device=device),
        norm0=BatchNormT(init_features, device),
        relu0=nn.ReLU(),
        pool0=max_pool_3x3_s2(),
    )
    features = init_features
    for i, num_layers in enumerate(block_config):
        layers[f"denseblock{i + 1}"] = DenseBlock(
            num_layers, features, growth_rate, bn_size, device
        )
        features += num_layers * growth_rate
        if i != len(block_config) - 1:
            layers[f"transition{i + 1}"] = Transition(features, features // 2, device)
            features //= 2
    layers["norm5"] = BatchNormT(features, device)
    return nn.Sequential(layers)


class DenseNetEncoder(nn.Module):
    """DenseNet feature tower: (B, H, W, 3) NHWC -> (B, num_features)."""

    def __init__(self, block_config: Sequence[int] = (6, 12, 24, 16), growth_rate: int = 32,
                 bn_size: int = 4, init_features: int = 64, device=None):
        super().__init__()
        self.model = nn.Sequential(
            densenet_features(block_config, growth_rate, bn_size, init_features, device)
        )

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        # NHWC at the API, NCHW shape for the convs. The permute is a view, so a
        # contiguous batch reaches cuDNN in channels_last memory format.
        x = images.permute(0, 3, 1, 2)
        # no ReLU after norm5: pool straight off it
        return global_avg_pool(self.model(x))


def densenet121(device=None) -> DenseNetEncoder:
    return DenseNetEncoder(device=device)


def tiny_densenet(device=None) -> DenseNetEncoder:
    """Miniature DenseNet (2+2 layers, 16-d features) with the densenet121
    code paths, for tests."""
    return DenseNetEncoder(block_config=(2, 2), growth_rate=4, bn_size=2,
                           init_features=8, device=device)
