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


def lecun_normal_(weight: torch.Tensor) -> torch.Tensor:
    """flax's default kernel initialiser (`lecun_normal`): a normal of
    variance 1 / fan_in truncated at two standard deviations, the standard
    deviation widened so the truncated draw keeps that variance. fan_in is
    every axis of a torch weight but the first (out, in[, kH, kW])."""
    fan_in = weight[0].numel()
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std)


def _uniform(shape, generator: Optional[torch.Generator],
             device: torch.device) -> torch.Tensor:
    """U[0, 1) of `shape` from `generator`, drawn on the generator's own
    device (None: torch's global generator of `device`) and moved to
    `device`."""
    draw_on = generator.device if generator is not None else device
    return torch.rand(shape, device=draw_on, generator=generator).to(device)


class DropPath(nn.Module):
    """Stochastic depth: drops the whole residual branch per sample; the
    identity in eval mode. `window_groups` > 1 marks window-partitioned
    input (leading dim = B * nW, sample-major): the per-sample mask is drawn
    at batch size B and repeated across each sample's nW windows.

    `draw(x)` returns the keep mask `forward` would draw (None when nothing
    is dropped), and `forward(x, keep)` applies a mask drawn earlier: a
    rematerialised block is run twice and must see one draw."""

    def __init__(self, rate: float = 0.0, window_groups: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rate = float(rate)
        self.window_groups = int(window_groups)
        self.generator = generator

    def draw(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        if not self.training or self.rate == 0.0:
            return None
        g = max(self.window_groups, 1)
        shape = (x.shape[0] // g,) + (1,) * (x.dim() - 1)
        return _uniform(shape, self.generator, x.device) < 1.0 - self.rate

    def forward(self, x, keep: Optional[torch.Tensor] = None):
        if keep is None:
            keep = self.draw(x)
        if keep is None:
            return x
        g = max(self.window_groups, 1)
        if g > 1:
            keep = keep.repeat_interleave(g, dim=0)
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


class Dropout(nn.Module):
    """Elementwise dropout that draws from the generator it was given
    (nn.Dropout can only use torch's global one)."""

    def __init__(self, rate: float = 0.5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rate = float(rate)
        self.generator = generator

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        keep = _uniform(x.shape, self.generator, x.device) >= self.rate
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


def set_generator(module: nn.Module,
                  generator: Optional[torch.Generator]) -> None:
    """Make every DropPath / Dropout under `module` draw from `generator`."""
    for m in module.modules():
        if isinstance(m, (DropPath, Dropout)):
            m.generator = generator


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
    (eps 1e-5). Train mode is torch's own: normalise with the biased batch
    variance, feed the UNBIASED one (n / (n - 1)) into running_var, momentum
    0.1 - which is what the JAX package's TorchBatchNorm reproduces
    (momentum 0.9 in flax's convention); flax's own nn.BatchNorm would feed
    the biased variance. One difference remains: torch refuses a training
    batch with a single value per channel, where the JAX package computes a
    zero variance."""

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
