"""ResNet-18 / ResNet-50 trunks, NHWC at every public function.

Counterpart of mmde_tpu/nn/resnet.py, the torchvision-equivalent feature
extractors the cnn_transformer / resnet_only encoders build on:

  * `ResNetFeatures`: stem + layer1 .. layer`num_stages`, a feature map per
    stage;
  * `ResNetMultiScale`: (f3, f4, f5) at strides 8 / 16 / 32;
  * `ResNetSingleScale`: the stride-16 feature, the trunk cut after layer3.

Channel counts are torchvision's: resnet50 (512, 1024, 2048) for f3 / f4 /
f5, resnet18 (128, 256, 512). The 3x3 stride-2 convs and the stem's max
pool pad (1, 1) as torch does (flax "SAME" would pad (0, 1) at stride 2 on
even extents, which the JAX package avoids too); the max pool pads with
-inf. BatchNorm (`layers.TorchBatchNorm`) keeps its statistics in float32
and casts its output to the activation type; torch momentum 0.1 is the JAX
package's flax momentum 0.9, eps 1e-5.

Parameter names are the reference PyTorch implementation's:
`ResNetFeatures` carries torchvision's (`conv1`, `bn1`, `layer1.0.conv1`,
`layer1.0.downsample.0`), and the two encoder trunks the reference's
`nn.Sequential(*resnet.children())` slices (`feature3.0` the stem conv,
`feature3.4` layer1, `feature4.0` layer3, `feature5.0` layer4; single
scale `feature.0` .. `feature.6`), the names
mmde_tpu/ckpt/torch_convert.py reads. Convolutions are initialised as
flax initialises them (`layers.lecun_normal_`), BatchNorm to identity.
Inside, maps are NCHW views of channels-last memory, as in the decoders.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from mmde_tpu_torch.nn.layers import Conv2d, TorchBatchNorm, lecun_normal_


def _conv(cin: int, cout: int, k: int, stride: int = 1,
          dtype: torch.dtype = torch.float32) -> Conv2d:
    m = Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False,
               dtype=dtype)
    lecun_normal_(m.weight)
    return m


class BasicBlock(nn.Module):
    """ResNet-18 / 34 block: two 3x3 convs, a 1x1 projection where the
    shape changes."""
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = _conv(cin, features, 3, stride, dtype)
        self.bn1 = TorchBatchNorm(features, dtype=dtype)
        self.conv2 = _conv(features, features, 3, 1, dtype)
        self.bn2 = TorchBatchNorm(features, dtype=dtype)
        self.downsample = None
        if stride != 1 or cin != features:
            self.downsample = nn.Sequential(
                _conv(cin, features, 1, stride, dtype),
                TorchBatchNorm(features, dtype=dtype))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        r = x if self.downsample is None else self.downsample(x)
        return F.relu(y + r)


class Bottleneck(nn.Module):
    """ResNet-50 block: 1x1 -> 3x3 (the stride) -> 1x1 at 4x the width."""
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out = 4 * features
        self.conv1 = _conv(cin, features, 1, 1, dtype)
        self.bn1 = TorchBatchNorm(features, dtype=dtype)
        self.conv2 = _conv(features, features, 3, stride, dtype)
        self.bn2 = TorchBatchNorm(features, dtype=dtype)
        self.conv3 = _conv(features, out, 1, 1, dtype)
        self.bn3 = TorchBatchNorm(out, dtype=dtype)
        self.downsample = None
        if stride != 1 or cin != out:
            self.downsample = nn.Sequential(
                _conv(cin, out, 1, stride, dtype),
                TorchBatchNorm(out, dtype=dtype))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        r = x if self.downsample is None else self.downsample(x)
        return F.relu(y + r)


_SPECS = {
    "resnet18": (BasicBlock, (2, 2, 2, 2)),
    "resnet50": (Bottleneck, (3, 4, 6, 3)),
}


def stage_channels(model: str) -> tuple:
    """Output channels of layer1 .. layer4."""
    block, _ = _SPECS[model]
    return tuple(block.expansion * 64 * 2 ** i for i in range(4))


def _trunk(model: str, num_stages: int, in_chans: int,
           dtype: torch.dtype) -> list:
    """[stem conv, stem bn, ReLU, max pool, layer1, .., layer`num_stages`]
    in the order of torchvision's children."""
    block, depths = _SPECS[model]
    stem = Conv2d(in_chans, 64, 7, stride=2, padding=3, bias=False,
                  dtype=dtype)
    lecun_normal_(stem.weight)
    mods = [stem, TorchBatchNorm(64, dtype=dtype), nn.ReLU(),
            nn.MaxPool2d(3, stride=2, padding=1)]
    cin, features = 64, 64
    for stage in range(num_stages):
        blocks = []
        for b in range(depths[stage]):
            stride = 2 if stage > 0 and b == 0 else 1
            blocks.append(block(cin, features, stride, dtype))
            cin = block.expansion * features
        mods.append(nn.Sequential(*blocks))
        features *= 2
    return mods


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> an NCHW view of the same (channels-last) memory."""
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class ResNetFeatures(nn.Module):
    """Stem + layer1 .. layer`num_stages` (torchvision's names): forward
    takes an NHWC image and returns the NHWC feature of every stage run."""

    def __init__(self, model: str = "resnet50", num_stages: int = 4,
                 in_chans: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        mods = _trunk(model, num_stages, in_chans, dtype)
        self.conv1, self.bn1 = mods[0], mods[1]
        self.num_stages = num_stages
        for i, layer in enumerate(mods[4:]):
            self.add_module(f"layer{i + 1}", layer)

    def forward(self, x) -> List[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(to_nchw(x))))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        feats = []
        for i in range(self.num_stages):
            x = getattr(self, f"layer{i + 1}")(x)
            feats.append(to_nhwc(x))
        return feats


class ResNetMultiScale(nn.Module):
    """(f3, f4, f5) at strides 8 / 16 / 32. `forward_nchw` keeps the maps as
    NCHW views for the encoders that build on it."""

    def __init__(self, model: str = "resnet50", in_chans: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        mods = _trunk(model, 4, in_chans, dtype)
        self.feature3 = nn.Sequential(*mods[:6])
        self.feature4 = nn.Sequential(mods[6])
        self.feature5 = nn.Sequential(mods[7])
        self.num_channels = stage_channels(model)[1:]

    def forward_nchw(self, x):
        f3 = self.feature3(x)
        f4 = self.feature4(f3)
        return f3, f4, self.feature5(f4)

    def forward(self, x):
        return tuple(to_nhwc(f) for f in self.forward_nchw(to_nchw(x)))


class ResNetSingleScale(nn.Module):
    """The stride-16 feature: the trunk cut after layer3."""

    def __init__(self, model: str = "resnet50", in_chans: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.feature = nn.Sequential(*_trunk(model, 3, in_chans, dtype))
        self.num_channels = stage_channels(model)[2]

    def forward_nchw(self, x):
        return self.feature(x)

    def forward(self, x):
        return to_nhwc(self.forward_nchw(to_nchw(x)))
