"""Shared layers: compute-type-aware Linear/Conv, MLP, DropPath, fp32 norms.

Counterpart of mmde_tpu/nn/layers.py. Numerics policy: parameters are stored
in float32; a module built with `dtype=torch.bfloat16` casts its input and
its weights to bfloat16 for the product (as a flax module with
`dtype=bfloat16, param_dtype=float32` does), while LayerNorm and BatchNorm
statistics always run in float32.

Parameter names follow the reference PyTorch implementation the JAX package
was itself modelled on (`weight`/`bias`, `running_mean`/`running_var`), so a
reference state dict keys straight into these modules.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def _cast(t: Optional[torch.Tensor], dtype: torch.dtype):
    return None if t is None else t.to(dtype)


class Linear(nn.Linear):
    """nn.Linear whose product runs in `dtype` (weights stay float32)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class Conv2d(nn.Conv2d):
    """nn.Conv2d (NCHW) whose product runs in `dtype`."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt),
                                  _cast(self.bias, dt))


class LayerNormFP32(nn.LayerNorm):
    """LayerNorm over the last axis computed in float32, cast back to the
    input type. eps defaults to 1e-6 (every backbone norm of the reference),
    not torch's 1e-5."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__(dim, eps=eps)

    def forward(self, x):
        y = F.layer_norm(x.float(), self.normalized_shape,
                         self.weight.float(), self.bias.float(), self.eps)
        return y.to(x.dtype)


class DropPath(nn.Module):
    """Stochastic depth: drops the whole residual branch per sample; the
    identity in eval mode. `window_groups` > 1 marks window-partitioned
    input (leading dim = B * nW, sample-major): the per-sample mask is drawn
    at batch size B and repeated across each sample's nW windows."""

    def __init__(self, rate: float = 0.0, window_groups: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rate = float(rate)
        self.window_groups = int(window_groups)
        self.generator = generator

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        g = max(self.window_groups, 1)
        keep = 1.0 - self.rate
        shape = (x.shape[0] // g,) + (1,) * (x.dim() - 1)
        gen = self.generator
        draw_on = gen.device if gen is not None else x.device
        mask = (torch.rand(shape, device=draw_on, generator=gen)
                < keep).to(x.device)
        if g > 1:
            mask = mask.repeat_interleave(g, dim=0)
        return torch.where(mask, x / keep, torch.zeros_like(x))


class Mlp(nn.Module):
    """Transformer FFN with exact (erf) GELU. `fp32_out` forces the second
    projection to float32."""

    def __init__(self, in_dim: int, hidden_dim: int,
                 out_dim: Optional[int] = None,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 use_norm: bool = False, fp32_out: bool = False):
        super().__init__()
        out_dim = out_dim or in_dim
        self.fc1 = Linear(in_dim, hidden_dim, dtype=dtype)
        self.norm = LayerNormFP32(hidden_dim) if use_norm else None
        self.fc2 = Linear(hidden_dim, out_dim,
                          dtype=torch.float32 if fp32_out else dtype)
        self.drop = nn.Dropout(dropout)

    def forward(self, x):
        x = self.fc1(x)
        if self.norm is not None:
            x = self.norm(x)
        x = F.gelu(x)                       # approximate="none": erf form
        x = self.drop(x)
        x = self.fc2(x)
        return self.drop(x)


class TorchBatchNorm(nn.BatchNorm2d):
    """BatchNorm over the channel axis of an NCHW tensor with the statistics
    and the normalisation in float32 and the OUTPUT cast to `dtype` (the
    input's type when None). Eval mode uses the running statistics
    (eps 1e-5); train mode is torch's own batch-statistics update."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(num_features, eps=eps, momentum=momentum)
        self.out_dtype = dtype

    def forward(self, x):
        out_dtype = self.out_dtype or x.dtype
        xf = x.float()
        if self.training:
            return super().forward(xf).to(out_dtype)
        shape = (1, -1, 1, 1)
        inv = torch.rsqrt(self.running_var.float() + self.eps)
        y = ((xf - self.running_mean.float().view(shape))
             * (inv * self.weight.float()).view(shape)
             + self.bias.float().view(shape))
        return y.to(out_dtype)


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d (NCHW) whose product runs in `dtype`."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.conv_transpose2d(
            x.to(dt), self.weight.to(dt), _cast(self.bias, dt), self.stride,
            self.padding, self.output_padding, self.groups, self.dilation)


def torch_deconv(in_channels: int, features: int, k: int, *,
                 dtype: torch.dtype = torch.float32) -> ConvTranspose2d:
    """ConvTranspose2d(k, stride=2) in the reference decoder's geometries:
    k=2 -> padding 0; k=4 -> padding 1; k=3 -> padding 1 + output padding 1.
    Each doubles the map. Bias-free, like the reference."""
    if k == 2:
        pad, out_pad = 0, 0
    elif k == 3:
        pad, out_pad = 1, 1
    elif k == 4:
        pad, out_pad = 1, 0
    else:
        raise ValueError(f"unsupported deconv kernel {k} "
                         "(the reference decoder supports 2/3/4)")
    return ConvTranspose2d(in_channels, features, k, stride=2, padding=pad,
                           output_padding=out_pad, bias=False, dtype=dtype)


class ConvBnRelu(nn.Module):
    """Conv (same padding, no bias) + BatchNorm + ReLU on NCHW tensors."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 strides: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(in_channels, features, kernel_size, stride=strides,
                           padding=kernel_size // 2, bias=False, dtype=dtype)
        self.bn = TorchBatchNorm(features, dtype=dtype)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))
