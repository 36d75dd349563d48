"""Hybrid CNN + transformer encoder and the ResNet-only encoder, NHWC at
every public function.

Counterpart of mmde_tpu/nn/cnn_transformer.py:

  * a ResNet-50 / 18 trunk (`nn.resnet`): the f3 / f4 / f5 features, or the
    single stride-16 one;
  * per-scale squeeze convs and the 3-scale fusion to `hidden_dim` at
    stride 16: f3 taken every second pixel, f5 repeated 2 x 2 (torch's
    nearest resize, which the JAX package writes as a slice and a repeat),
    both cropped to f4's grid - which binds where the input is not a
    multiple of 32, e.g. 240 rows: f4 15 rows, f5 repeated 16;
  * the DETR sine position embedding (temperature 20, normalised), a
    numpy table of the static map size (`sine_position_embedding`, the
    port's own copy);
  * post-norm encoder layers: q = k = x + pos, v = x, the residual on v,
    LayerNorm at eps 1e-5 in float32 (whose float32 output the following
    layer takes, as in the JAX package), a ReLU feed-forward;
  * `ResNetOnly`: the feature extractor without the transformer.

The JAX package's attention here is flax's `MultiHeadDotProductAttention`
(4 heads at hidden 256, 8 otherwise; q scaled by 1/sqrt(Dh)), an XLA
computation there, not a Pallas kernel: its counterpart is plain PyTorch
products and softmax in the model's type. Its q / k / v kernels (C, nH,
Dh) and out kernel (nH, Dh, C) are held as torch's packed
`self_attn.in_proj_weight` (3C, C) / `in_proj_bias` and `out_proj`, as
mmde_tpu/ckpt/torch_convert.py lays them out; every name follows the
reference PyTorch encoder (`feature_extractor.feat_squeeze1.0.conv`,
`feature_extractor.feat_combine.0`, `transformer_encoder.0.ffn1.0`).
Dense layers and convolutions start from flax's initialisers
(`layers.lecun_normal_`, zero biases).
"""
from __future__ import annotations

import math
from typing import List

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from mmde_tpu_torch.nn.layers import (Conv2d, ConvBnRelu, Linear,
                                      TorchBatchNorm, lecun_normal_)
from mmde_tpu_torch.nn.resnet import (ResNetMultiScale, ResNetSingleScale,
                                      to_nchw, to_nhwc)


def sine_position_embedding(h: int, w: int, num_pos_feats: int,
                            temperature: float = 20.0,
                            normalize: bool = True) -> np.ndarray:
    """(1, h, w, 2 * num_pos_feats) sine / cosine position grid of the DETR
    embedding for an all-valid mask (the cumulative sums are 1..h / 1..w)."""
    y = np.arange(1, h + 1, dtype=np.float32)[:, None] * np.ones((1, w),
                                                                 np.float32)
    x = np.ones((h, 1), np.float32) * np.arange(1, w + 1,
                                                dtype=np.float32)[None, :]
    if normalize:
        eps = 1e-6
        scale = 2 * math.pi
        y = y / (y[-1:, :] + eps) * scale
        x = x / (x[:, -1:] + eps) * scale
    dim_t = np.arange(num_pos_feats, dtype=np.float32)
    dim_t = temperature ** (2 * (dim_t // 2) / num_pos_feats)
    pos_x = x[:, :, None] / dim_t
    pos_y = y[:, :, None] / dim_t
    pos_x = np.stack([np.sin(pos_x[:, :, 0::2]), np.cos(pos_x[:, :, 1::2])],
                     axis=3).reshape(h, w, -1)
    pos_y = np.stack([np.sin(pos_y[:, :, 0::2]), np.cos(pos_y[:, :, 1::2])],
                     axis=3).reshape(h, w, -1)
    return np.concatenate([pos_y, pos_x], axis=-1)[None].astype(np.float32)


def _squeeze(cin: int, hidden: int, dtype) -> nn.Sequential:
    seq = nn.Sequential(ConvBnRelu(cin, hidden, 3, dtype=dtype),
                        ConvBnRelu(hidden, hidden, 3, dtype=dtype))
    for m in seq:
        lecun_normal_(m.conv.weight)
    return seq


def _conv1x1(cin: int, cout: int, dtype) -> Conv2d:
    m = Conv2d(cin, cout, 1, dtype=dtype)
    lecun_normal_(m.weight)
    nn.init.zeros_(m.bias)
    return m


class FeatureExtractorMultiScale(nn.Module):
    """The 3-scale squeeze and fusion to `hidden_dim` at stride 16.
    forward: NHWC image -> NHWC (B, H/16, W/16, hidden_dim)."""

    def __init__(self, hidden_dim: int, cnn_model: str = "resnet50",
                 in_chans: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.backbone = ResNetMultiScale(cnn_model, in_chans, dtype)
        c3, c4, c5 = self.backbone.num_channels
        self.feat_squeeze1 = _squeeze(c3, hidden_dim, dtype)
        self.feat_squeeze2 = _squeeze(c4, hidden_dim, dtype)
        self.feat_squeeze3 = _squeeze(c5, hidden_dim, dtype)
        self.feat_combine = nn.Sequential(
            _conv1x1(3 * hidden_dim, hidden_dim, dtype),
            TorchBatchNorm(hidden_dim, dtype=dtype), nn.ReLU(),
            _conv1x1(hidden_dim, hidden_dim, dtype))

    def forward(self, x):
        f3, f4, f5 = self.backbone.forward_nchw(to_nchw(x))
        f3 = self.feat_squeeze1(f3)
        f4 = self.feat_squeeze2(f4)
        f5 = self.feat_squeeze3(f5)
        # torch's nearest x0.5 / x2 as a slice and a repeat, then f4's grid
        Hf, Wf = f4.shape[2], f4.shape[3]
        f3 = f3[:, :, ::2, ::2][:, :, :Hf, :Wf]
        f5 = f5.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        f5 = f5[:, :, :Hf, :Wf]
        fused = torch.cat([f3, f4, f5], dim=1)
        return to_nhwc(self.feat_combine(fused))


class FeatureExtractorSingleScale(nn.Module):
    """The single stride-16 squeeze. forward: NHWC -> NHWC."""

    def __init__(self, hidden_dim: int, cnn_model: str = "resnet50",
                 in_chans: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.backbone = ResNetSingleScale(cnn_model, in_chans, dtype)
        self.feat_squeeze = _squeeze(self.backbone.num_channels, hidden_dim,
                                     dtype)

    def forward(self, x):
        return to_nhwc(self.feat_squeeze(
            self.backbone.forward_nchw(to_nchw(x))))


def _linear(cin: int, cout: int, dtype) -> Linear:
    m = Linear(cin, cout, dtype=dtype)
    lecun_normal_(m.weight)
    nn.init.zeros_(m.bias)
    return m


class MultiheadAttention(nn.Module):
    """flax's MultiHeadDotProductAttention under torch's parameter layout:
    q, k, v = the three row blocks of `in_proj_weight` applied to their
    inputs, softmax(q k^T / sqrt(Dh)) v per head, `out_proj`; every product
    and the softmax in `dtype`."""

    def __init__(self, dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        for w in self.in_proj_weight.data.chunk(3):
            lecun_normal_(w)
        self.out_proj = _linear(dim, dim, dtype)

    def forward(self, q, k, v):
        B, L, C = q.shape
        nH, dt = self.num_heads, self.dtype
        w = self.in_proj_weight.to(dt).chunk(3)
        b = self.in_proj_bias.to(dt).chunk(3)

        def heads(x, i):
            return F.linear(x.to(dt), w[i], b[i]).reshape(
                B, -1, nH, C // nH).transpose(1, 2)

        qh, kh, vh = heads(q, 0), heads(k, 1), heads(v, 2)
        qh = qh / torch.tensor(math.sqrt(C // nH), dtype=dt)
        a = torch.softmax(qh @ kh.transpose(-1, -2), dim=-1)
        o = (a @ vh).transpose(1, 2).reshape(B, L, C)
        return self.out_proj(o)


class TransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer: q = k = x + pos, v = x, the residual on v;
    the two LayerNorms (eps 1e-5) compute and return float32. Dropout is
    0 in every configuration the JAX package builds, so none is drawn."""

    def __init__(self, hidden_dim: int, ff_dim: int = 4096,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        num_heads = 4 if hidden_dim == 256 else 8
        self.self_attn = MultiheadAttention(hidden_dim, num_heads, dtype)
        self.norm1 = nn.LayerNorm(hidden_dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(hidden_dim, eps=1e-5)
        self.ffn1 = nn.Sequential(_linear(hidden_dim, ff_dim, dtype),
                                  nn.ReLU())
        self.ffn2 = nn.Sequential(_linear(ff_dim, hidden_dim, dtype))

    def forward(self, x, pos):
        q = x + pos
        x = self.norm1((x + self.self_attn(q, q, x)).float())
        x = x + self.ffn2(self.ffn1(x))
        return self.norm2(x.float())


class CnnTransformer(nn.Module):
    """ResNet features + sine positions + `n_enc_layers` encoder layers.
    forward: NHWC image -> [NHWC feature (B, H/16, W/16, hidden_dim)],
    float32 after the first layer (its LayerNorm's type)."""

    def __init__(self, hidden_dim: int = 512, n_enc_layers: int = 6,
                 multi_scale: bool = True, cnn_model: str = "resnet50",
                 ff_dim: int = 4096, in_chans: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden_dim = hidden_dim
        fe = (FeatureExtractorMultiScale if multi_scale
              else FeatureExtractorSingleScale)
        self.feature_extractor = fe(hidden_dim, cnn_model, in_chans, dtype)
        self.transformer_encoder = nn.ModuleList(
            TransformerEncoderLayer(hidden_dim, ff_dim, dtype)
            for _ in range(n_enc_layers))
        self._pos_cache: dict = {}

    def _pos(self, H: int, W: int, C: int, ref: torch.Tensor):
        key = (H, W, C, ref.dtype, str(ref.device))
        if key not in self._pos_cache:
            pos = torch.from_numpy(sine_position_embedding(H, W, C // 2))
            # never an inference tensor: a training forward saves it
            with torch.inference_mode(False):
                self._pos_cache[key] = pos.reshape(1, H * W, C).to(
                    device=ref.device, dtype=ref.dtype)
        return self._pos_cache[key]

    def forward(self, x) -> List[torch.Tensor]:
        feat = self.feature_extractor(x)
        B, H, W, C = feat.shape
        pos = self._pos(H, W, C, feat)
        tokens = feat.reshape(B, H * W, C)
        for layer in self.transformer_encoder:
            tokens = layer(tokens, pos)
        return [tokens.reshape(B, H, W, C)]


class ResNetOnly(nn.Module):
    """The feature extractor without the transformer: NHWC image ->
    [NHWC (B, H/16, W/16, hidden_dim)]."""

    def __init__(self, hidden_dim: int = 512, multi_scale: bool = True,
                 cnn_model: str = "resnet50", in_chans: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden_dim = hidden_dim
        fe = (FeatureExtractorMultiScale if multi_scale
              else FeatureExtractorSingleScale)
        self.feature_extractor = fe(hidden_dim, cnn_model, in_chans, dtype)

    def forward(self, x) -> List[torch.Tensor]:
        return [self.feature_extractor(x)]
