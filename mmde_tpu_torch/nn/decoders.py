"""Twin-headed decoders: dense depth + relative pose regression.

Counterpart of mmde_tpu/nn/decoders.py. Public forwards take and return
NHWC tensors like the JAX package; inside, maps are NCHW views of the same
memory (channels-last strides), which is what cuDNN prefers.

  * DecoderPose: conv + two stride-2 conv blocks (padding 1) -> global
    average pool -> two MLP regressors (9-dim rotation, 3-dim translation)
    with dropout 0.5; rotation projected by SVD (geometry.normalize_rotation).
  * DecoderDepth: N ConvTranspose(k, s2) + BN + ReLU blocks -> conv + BN +
    ReLU -> bilinear x2 upsampling loop -> 2-conv head -> sigmoid * max_depth
    (float32).
  * DecoderV1: one pass over concat(f1, f2), 2-channel depth head split into
    (d1, d2); pose in the forward direction only.
  * DecoderV2: two passes with swapped concat: (d1, r12, t12), (d2, r21, t21).

Module names follow the reference PyTorch decoder (`decoder_pose.pos_layers`,
`decoder_depth.deconv_layers`, ...). Convs are initialised normal(std 0.001),
BatchNorm to identity, as in the reference.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from mmde_tpu_torch.geometry import normalize_rotation
from mmde_tpu_torch.nn.layers import (Conv2d, Linear, TorchBatchNorm,
                                      torch_deconv)


def _conv(cin: int, cout: int, stride: int, dtype) -> Conv2d:
    m = Conv2d(cin, cout, 3, stride=stride, padding=1, dtype=dtype)
    nn.init.normal_(m.weight, std=0.001)
    nn.init.zeros_(m.bias)
    return m


def _to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class Regression(nn.Module):
    """3-layer MLP head with dropout 0.5."""

    def __init__(self, in_dim: int, out_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.reg_layer = nn.Sequential(
            Linear(in_dim, in_dim // 2, dtype=dtype), nn.ReLU(),
            nn.Dropout(0.5),
            Linear(in_dim // 2, in_dim // 4, dtype=dtype), nn.ReLU(),
            nn.Dropout(0.5),
            Linear(in_dim // 4, out_dim, dtype=dtype))

    def forward(self, x):
        return self.reg_layer(x)


class DecoderPose(nn.Module):
    """Pose head on an NHWC feature map -> (rot (B, 9), trans (B, 3))."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = channels

        def block(stride):
            return [_conv(c, c, stride, dtype), TorchBatchNorm(c, dtype=dtype),
                    nn.ReLU()]

        self.pos_layers = nn.Sequential(*block(1))
        self.pos_layer_down1 = nn.Sequential(*block(2), *block(1))
        self.pos_layer_down2 = nn.Sequential(*block(2), *block(1))
        self.rotat_reg_layer = Regression(c, 9, dtype=dtype)
        self.trans_reg_layer = Regression(c, 3, dtype=dtype)

    def forward(self, feats):
        x = _to_nchw(feats)
        x = self.pos_layers(x)
        x = self.pos_layer_down1(x)
        x = self.pos_layer_down2(x)
        x = x.mean(dim=(2, 3))                           # global avg pool
        rot = self.rotat_reg_layer(x)
        trans = self.trans_reg_layer(x)
        return normalize_rotation(rot), trans


class DecoderDepth(nn.Module):
    """Depth head on an NHWC feature map -> (B, H*, W*, head_channels)
    float32 depth in (0, max_depth)."""

    def __init__(self, in_channels: int, out_channels: int, max_depth: float,
                 num_deconv: int = 3, num_filters: Sequence[int] = (32, 32, 32),
                 deconv_kernels: Sequence[int] = (2, 2, 2),
                 num_upscale: int = 2, head_channels: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.max_depth = float(max_depth)
        self.num_upscale = num_upscale
        layers = []
        c = in_channels
        for i in range(num_deconv):
            d = torch_deconv(c, num_filters[i], deconv_kernels[i], dtype=dtype)
            nn.init.normal_(d.weight, std=0.001)
            layers += [d, TorchBatchNorm(num_filters[i], dtype=dtype),
                       nn.ReLU()]
            c = num_filters[i]
        self.deconv_layers = nn.Sequential(*layers)
        self.conv_layers = nn.Sequential(
            _conv(c, out_channels, 1, dtype),
            TorchBatchNorm(out_channels, dtype=dtype), nn.ReLU())
        self.last_layer = nn.Sequential(
            _conv(out_channels, out_channels, 1, dtype), nn.ReLU(),
            _conv(out_channels, head_channels, 1, dtype))

    def forward(self, feats):
        x = _to_nchw(feats)
        x = self.deconv_layers(x)
        x = self.conv_layers(x)
        for _ in range(self.num_upscale):
            x = F.interpolate(x, scale_factor=2, mode="bilinear",
                              align_corners=False)
        x = self.last_layer(x)
        return torch.sigmoid(_to_nhwc(x).float()) * self.max_depth


class DecoderV1(nn.Module):
    """Single pass, fused 2-channel depth + one pose direction. Returns
    (d1, r12, t12, d2, None, None)."""

    def __init__(self, in_channels: int, max_depth: float,
                 num_deconv: int = 3, num_filters: Sequence[int] = (32, 32, 32),
                 deconv_kernels: Sequence[int] = (2, 2, 2),
                 num_upscale: int = 2, out_channels: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.decoder_pose = DecoderPose(2 * in_channels, dtype=dtype)
        self.decoder_depth = DecoderDepth(
            2 * in_channels, out_channels, max_depth, num_deconv=num_deconv,
            num_filters=num_filters, deconv_kernels=deconv_kernels,
            num_upscale=num_upscale, head_channels=2, dtype=dtype)

    def forward(self, feat1, feat2):
        feats = torch.cat([feat1, feat2], dim=-1)
        rot, trans = self.decoder_pose(feats)
        depth = self.decoder_depth(feats)
        return depth[..., 0:1], rot, trans, depth[..., 1:2], None, None


class DecoderV2(nn.Module):
    """Two passes with swapped feature order: bidirectional depth + pose."""

    def __init__(self, in_channels: int, max_depth: float,
                 num_deconv: int = 3, num_filters: Sequence[int] = (32, 32, 32),
                 deconv_kernels: Sequence[int] = (2, 2, 2),
                 num_upscale: int = 2, out_channels: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.decoder_pose = DecoderPose(2 * in_channels, dtype=dtype)
        self.decoder_depth = DecoderDepth(
            2 * in_channels, out_channels, max_depth, num_deconv=num_deconv,
            num_filters=num_filters, deconv_kernels=deconv_kernels,
            num_upscale=num_upscale, head_channels=1, dtype=dtype)

    def forward(self, feat1, feat2):
        f12 = torch.cat([feat1, feat2], dim=-1)
        r12, t12 = self.decoder_pose(f12)
        d1 = self.decoder_depth(f12)
        f21 = torch.cat([feat2, feat1], dim=-1)
        r21, t21 = self.decoder_pose(f21)
        d2 = self.decoder_depth(f21)
        return d1, r12, t12, d2, r21, t21
