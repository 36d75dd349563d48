"""The legacy GLPDepth model family, NHWC at every public function.

Counterpart of mmde_tpu/models/glpdepth.py:

  * `GLPDepth`: single frame, a stride-32 swin feature -> three 2x2
    deconvs -> two bilinear x2 upsamples -> a 2-conv head -> sigmoid x
    max_depth. forward(image) -> {"pred_d": (B, H, W, 1)}.
  * `GLPDepthScale16`: two frames, the stride-16 variant (swin stages 1-3,
    or the cnn_transformer / resnet_only encoders) with a fused decoder: a
    2-channel depth map and the 12-dim `out_p` pose vector (rot9 +
    trans3). With `sparse_depth_input`, depth completion: each frame takes
    its sparse depth / max_depth and its validity (sparse > 0) as two more
    input channels (5 into the patch embed), frame 2 falling back to frame
    1's sparse depth. forward -> {"pred_d1", "pred_d2", "out_p"}.
  * `Scale16TwoFrame`: GLPDepthScale16 behind the two-frame prediction dict
    (`out_p` split into pred_r12 / pred_t12, no reverse direction, as
    decoder_v1), `out_p` kept.

The two frames go through the encoder interleaved on the batch axis, as in
`two_frame.TwoFrameDepthPose`. The pose conv stack pads (1, 1) at stride 2
as torch does; the bilinear x2 upsamples are `decoders.upsample2x`
(jax.image.resize's half-pixel bilinear). Dropout in `_WideRegression`
draws from the generator `layers.set_generator` installs.

No converter in the JAX package names these heads, so their parameter
names mirror the JAX module path (`decoder.deconv_0`, `decoder.conv_bn`,
`head_a`; under Scale16TwoFrame `net.encoder.layers.0...`, `net.pos1a`,
`net.bn_pos1a`, `net.rot_head.fc2`, `net.depth_stack.deconv_1`); the
encoders keep their reference names. Convs and deconvs start from
normal(std 0.001), BatchNorm from identity, dense layers from flax's
initialiser, as there.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from mmde_tpu_torch.config import ModelConfig
from mmde_tpu_torch.nn.decoders import upsample2x
from mmde_tpu_torch.nn.layers import (Conv2d, Dropout, Linear,
                                      TorchBatchNorm, lecun_normal_,
                                      torch_deconv)
from mmde_tpu_torch.nn.resnet import to_nchw, to_nhwc
from mmde_tpu_torch.nn.swin_v2 import SwinTransformerV2


def _conv(cin: int, cout: int, stride: int, dtype) -> Conv2d:
    m = Conv2d(cin, cout, 3, stride=stride, padding=1, dtype=dtype)
    nn.init.normal_(m.weight, std=0.001)
    nn.init.zeros_(m.bias)
    return m


class _DeconvStack(nn.Module):
    """Deconv tower + conv head of the legacy decoders, NCHW in and out:
    `num_deconv` x (deconv k, stride 2 -> BatchNorm -> ReLU), then conv 3x3
    -> BatchNorm -> ReLU to `out_channels`."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_deconv: int = 3,
                 num_filters: Sequence[int] = (32, 32, 32),
                 deconv_kernels: Sequence[int] = (2, 2, 2),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_deconv = num_deconv
        c = in_channels
        for i in range(num_deconv):
            d = torch_deconv(c, num_filters[i], deconv_kernels[i],
                             dtype=dtype)
            nn.init.normal_(d.weight, std=0.001)
            self.add_module(f"deconv_{i}", d)
            self.add_module(f"deconv_bn_{i}",
                            TorchBatchNorm(num_filters[i], dtype=dtype))
            c = num_filters[i]
        self.conv = _conv(c, out_channels, 1, dtype)
        self.conv_bn = TorchBatchNorm(out_channels, dtype=dtype)

    def forward(self, x):
        for i in range(self.num_deconv):
            x = getattr(self, f"deconv_{i}")(x)
            x = F.relu(getattr(self, f"deconv_bn_{i}")(x))
        return F.relu(self.conv_bn(self.conv(x)))


class _WideRegression(nn.Module):
    """The 512-wide MLP head of the scale16 decoder: fc1 512 -> ReLU ->
    Dropout 0.5 -> fc2 512 -> ReLU -> Dropout 0.5 -> fc3."""

    def __init__(self, in_dim: int, out_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Linear(in_dim, 512, dtype=dtype)
        self.fc2 = Linear(512, 512, dtype=dtype)
        self.fc3 = Linear(512, out_dim, dtype=dtype)
        for fc in (self.fc1, self.fc2, self.fc3):
            lecun_normal_(fc.weight)
            nn.init.zeros_(fc.bias)
        self.drop1 = Dropout(0.5)
        self.drop2 = Dropout(0.5)

    def forward(self, x):
        x = self.drop1(F.relu(self.fc1(x)))
        x = self.drop2(F.relu(self.fc2(x)))
        return self.fc3(x)


def _swin(cfg: ModelConfig, num_stages: int, in_chans: int,
          dtype: torch.dtype,
          generator: Optional[torch.Generator]) -> SwinTransformerV2:
    """The swin encoder of these families: the first `num_stages` stages,
    the last one's feature out; the arguments the JAX family passes (the
    rest at the module's defaults)."""
    from mmde_tpu_torch.models.two_frame import (SWIN_VARIANTS,
                                                 resolve_attn_impl)
    variant = next(v for v in SWIN_VARIANTS if v in cfg.backbone)
    embed_dim, num_heads = SWIN_VARIANTS[variant]
    s = cfg.swin
    n = num_stages
    return SwinTransformerV2(
        embed_dim=embed_dim, depths=tuple(s.depths[:n]),
        num_heads=num_heads[:n], window_size=tuple(s.window_size[:n]),
        pretrain_window_size=tuple(s.pretrain_window_size[:n]),
        use_shift=tuple(s.use_shift[:n]), out_indices=(n - 1,),
        drop_path_rate=s.drop_path_rate, use_checkpoint=s.use_checkpoint,
        attn_impl=resolve_attn_impl(cfg), in_chans=in_chans, dtype=dtype,
        generator=generator)


class GLPDepth(nn.Module):
    """Single-frame depth: forward(image (B, H, W, 3) float) ->
    {"pred_d": (B, H, W, 1) float32}."""

    def __init__(self, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        from mmde_tpu_torch.models.two_frame import (SWIN_VARIANTS,
                                                     _model_dtype)
        self.cfg = cfg
        self.dtype = _model_dtype(cfg)
        variant = next(v for v in SWIN_VARIANTS if v in cfg.backbone)
        embed_dim = SWIN_VARIANTS[variant][0]
        n = len(cfg.swin.depths)
        self.encoder = _swin(cfg, n, 3, self.dtype, generator)
        self.decoder = _DeconvStack(embed_dim * 2 ** (n - 1), embed_dim,
                                    dtype=self.dtype)
        self.head_a = _conv(embed_dim, embed_dim, 1, self.dtype)
        self.head_b = _conv(embed_dim, 1, 1, self.dtype)

    def forward(self, image):
        f = self.encoder(image.to(self.dtype))[-1]
        x = self.decoder(to_nchw(f))
        x = upsample2x(upsample2x(x))
        x = self.head_b(F.relu(self.head_a(x)))
        return {"pred_d": torch.sigmoid(to_nhwc(x).float())
                * self.cfg.max_depth}


def fuse_sparse(frame: torch.Tensor, sparse: torch.Tensor,
                max_depth: float) -> torch.Tensor:
    """(B, H, W, 3) frame + (B, H, W[, 1]) sparse depth -> (B, H, W, 5):
    the frame, sparse / max_depth, and (sparse > 0) in the frame's type."""
    if sparse.dim() == frame.dim() - 1:
        sparse = sparse[..., None]
    valid = (sparse > 0).to(frame.dtype)
    return torch.cat([frame, sparse / max_depth, valid], dim=-1)


class GLPDepthScale16(nn.Module):
    """Two frames at stride 16 with the fused depth + `out_p` decoder.
    forward(frame1, frame2, sparse1=None, sparse2=None) with NHWC float
    frames -> {"pred_d1", "pred_d2": (B, H, W, 1) float32, "out_p": (B,
    12)}. A model built with `sparse_depth_input` takes 5-channel input and
    wants sparse1."""

    def __init__(self, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        from mmde_tpu_torch.models.two_frame import (_build_encoder,
                                                     _model_dtype)
        self.cfg = cfg
        self.dtype = dt = _model_dtype(cfg)
        in_chans = 5 if cfg.sparse_depth_input else 3
        if "swin" in cfg.backbone:
            n = len(cfg.swin.depths) - 1
            self.encoder = _swin(cfg, n, in_chans, dt, generator)
            embed_dim = self.encoder.num_features[0]
            C = 2 * self.encoder.num_features[-1]
        else:
            embed_dim = 128
            self.encoder = _build_encoder(cfg, dt, generator, in_chans)
            C = 2 * self.encoder.hidden_dim
        self.pos0 = _conv(C, C, 1, dt)
        self.bn_pos0 = TorchBatchNorm(C, dtype=dt)
        self.pos1a = _conv(C, C, 2, dt)
        self.bn_pos1a = TorchBatchNorm(C, dtype=dt)
        self.pos1b = _conv(C, C, 1, dt)
        self.bn_pos1b = TorchBatchNorm(C, dtype=dt)
        self.pos2a = _conv(C, C, 2, dt)
        self.bn_pos2a = TorchBatchNorm(C, dtype=dt)
        self.pos2b = _conv(C, C, 1, dt)
        self.bn_pos2b = TorchBatchNorm(C, dtype=dt)
        self.rot_head = _WideRegression(C, 9, dt)
        self.trans_head = _WideRegression(C, 3, dt)
        self.depth_stack = _DeconvStack(C, embed_dim * 2, dtype=dt)
        self.head_a = _conv(embed_dim * 2, embed_dim * 2, 1, dt)
        self.head_b = _conv(embed_dim * 2, 2, 1, dt)

    def forward(self, frame1, frame2, sparse1=None, sparse2=None):
        if self.cfg.sparse_depth_input:
            if sparse1 is None:
                raise ValueError("this model was built for sparse depth "
                                 "input (sparse_depth_input): pass sparse1")
            md = self.cfg.max_depth
            frame1 = fuse_sparse(frame1, sparse1, md)
            frame2 = fuse_sparse(frame2, sparse1 if sparse2 is None
                                 else sparse2, md)
        B = frame1.shape[0]
        frames = torch.stack([frame1, frame2], dim=1).to(self.dtype)
        frames = frames.reshape((2 * B,) + tuple(frames.shape[2:]))
        f = self.encoder(frames)[-1]
        f = f.reshape((B, 2) + tuple(f.shape[1:]))
        feats = to_nchw(torch.cat([f[:, 0], f[:, 1]], dim=-1))

        p = feats
        for i in ("0", "1a", "1b", "2a", "2b"):
            p = F.relu(getattr(self, f"bn_pos{i}")(
                getattr(self, f"pos{i}")(p)))
        p = p.mean(dim=(2, 3))
        out_p = torch.cat([self.rot_head(p), self.trans_head(p)], dim=-1)

        d = upsample2x(self.depth_stack(feats))
        d = self.head_b(F.relu(self.head_a(d)))
        depth = torch.sigmoid(to_nhwc(d).float()) * self.cfg.max_depth
        return {"pred_d1": depth[..., 0:1], "pred_d2": depth[..., 1:2],
                "out_p": out_p}


class Scale16TwoFrame(nn.Module):
    """GLPDepthScale16 (`net`) through the two-frame prediction dict:
    pred_r12 = out_p[:, :9], pred_t12 = out_p[:, 9:12], no reverse
    direction (r21 / t21 None), `out_p` kept."""

    def __init__(self, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.net = GLPDepthScale16(cfg, generator)

    def forward(self, frame1, frame2, sparse1=None, sparse2=None):
        out = self.net(frame1, frame2, sparse1, sparse2)
        out_p = out["out_p"]
        return {"pred_d1": out["pred_d1"], "pred_d2": out["pred_d2"],
                "pred_r12": out_p[:, :9], "pred_t12": out_p[:, 9:12],
                "pred_r21": None, "pred_t21": None, "out_p": out_p}

