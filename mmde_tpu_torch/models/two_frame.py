"""Two-frame depth + relative-pose model assembly.

Counterpart of mmde_tpu/models/two_frame.py:
  * encoder selected by backbone string: swin_{nano,tiny,base,large,huge}_v2
    with embed_dim 32/96/128/192/352 and matching head counts;
    cnn_transformer[_multi_scale] / resnet_only[_multi_scale] with
    resnet50 / resnet18 trunks (nn/cnn_transformer.py);
  * model_scale 32 (4 swin stages, stride-32 feature) vs 16 (3 stages,
    stride-16 feature);
  * decoder_v1 / decoder_v2 twin heads;
  * forward: the two frames interleaved on the batch axis through the shared
    encoder, then split for the decoder.

`build_model` builds the three families (`cfg.family`): two_frame (this
module), glpdepth_scale16 and glpdepth (models/glpdepth.py). All derived
hyperparameters live in the pure `build_plan` function, so configs stay
immutable.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch
import torch.nn as nn

from mmde_tpu_torch.config import ModelConfig
from mmde_tpu_torch.nn.cnn_transformer import CnnTransformer, ResNetOnly
from mmde_tpu_torch.nn.decoders import DecoderV1, DecoderV2
from mmde_tpu_torch.nn.swin_v2 import SwinTransformerV2

# embed_dim / num_heads per swin variant. "nano" is a 32-wide variant for
# tests: the decoder_v2 pose branch is O(C^2)-wide (5 convs at 2*C_last
# channels), so even swin_tiny drags ~100M pose-conv params into small runs.
SWIN_VARIANTS = {
    "nano": (32, (1, 2, 4, 8)),
    "tiny": (96, (3, 6, 12, 24)),
    "base": (128, (4, 8, 16, 32)),
    "large": (192, (6, 12, 24, 48)),
    "huge": (352, (11, 22, 44, 88)),
}

@dataclass(frozen=True)
class BuildPlan:
    """Derived wiring for an encoder/decoder pair."""
    channels_in: int
    channels_out: int
    num_deconv: int
    num_filters: Tuple[int, ...]
    deconv_kernels: Tuple[int, ...]
    num_upscale: int


def build_plan(cfg: ModelConfig) -> BuildPlan:
    b = cfg.backbone
    if "swin" in b:
        variant = next((v for v in SWIN_VARIANTS if v in b), None)
        if variant is None:
            raise ValueError(f"unknown swin variant in backbone '{b}'")
        embed_dim, _ = SWIN_VARIANTS[variant]
        if cfg.model_scale == 32:
            return BuildPlan(embed_dim * 8, embed_dim, 3, (32, 32, 32),
                             (2, 2, 2), 2)
        if cfg.model_scale == 16:
            return BuildPlan(embed_dim * 4, embed_dim, 3, (32, 32, 32),
                             (2, 2, 2), 1)
        raise ValueError(f"model_scale must be 16 or 32, got {cfg.model_scale}")
    if "cnn_transformer" in b or "resnet_only" in b:
        cm = cfg.cnn.cnn_model
        if cm in ("resnet50", "50"):
            return BuildPlan(512, 128, 3, (32, 32, 32), (2, 2, 2), 1)
        if cm in ("resnet18", "18"):
            return BuildPlan(256, 128, 2, (32, 32), (2, 2), 2)
        raise ValueError(f"unknown cnn_model '{cm}'")
    raise ValueError(f"backbone '{b}' is not registered")


def resolve_attn_impl(cfg: ModelConfig) -> str:
    """Attention implementation, resolved once at model build: an explicit
    cfg.attn_impl wins ("cuda" | "cuda_slab" | "torch", or the JAX package's
    "pallas" | "pallas_slab" | "xla" read as their counterparts); otherwise
    derived from use_pallas_attention."""
    if cfg.attn_impl:
        impl = {"pallas": "cuda", "pallas_slab": "cuda_slab",
                "xla": "torch"}.get(cfg.attn_impl, cfg.attn_impl)
        if impl not in ("cuda", "cuda_slab", "torch"):
            raise ValueError(f"unknown attn_impl '{cfg.attn_impl}'")
        return impl
    return "cuda" if cfg.use_pallas_attention else "torch"


def _model_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _build_encoder(cfg: ModelConfig, dtype: torch.dtype,
                   generator: Optional[torch.Generator],
                   in_chans: int = 3) -> nn.Module:
    """The encoder of `cfg.backbone`; `in_chans` input channels (5 with
    sparse depth fused in)."""
    b = cfg.backbone
    if "swin" not in b:
        cm = cfg.cnn.cnn_model
        if cm not in ("resnet50", "50", "resnet18", "18"):
            raise ValueError(f"unknown cnn_model '{cm}'")
        model = "resnet50" if cm in ("resnet50", "50") else "resnet18"
        hidden = 512 if model == "resnet50" else 256
        multi = b.endswith("multi_scale")
        if "cnn_transformer" in b:
            return CnnTransformer(hidden_dim=hidden, n_enc_layers=6,
                                  multi_scale=multi, cnn_model=model,
                                  ff_dim=cfg.cnn.transformer_ff_dim,
                                  in_chans=in_chans, dtype=dtype)
        if "resnet_only" in b:
            return ResNetOnly(hidden_dim=hidden, multi_scale=multi,
                              cnn_model=model, in_chans=in_chans,
                              dtype=dtype)
        raise ValueError(f"backbone '{b}' is not registered")
    variant = next(v for v in SWIN_VARIANTS if v in b)
    embed_dim, num_heads = SWIN_VARIANTS[variant]
    s = cfg.swin
    if cfg.model_scale == 32:
        depths, heads = tuple(s.depths), num_heads
        window, pwin = tuple(s.window_size), tuple(s.pretrain_window_size)
        shift = tuple(s.use_shift)
    else:  # 16: drop the last stage
        depths = tuple(s.depths[:-1])
        heads = num_heads[:len(depths)]
        window = tuple(s.window_size[:len(depths)])
        pwin = tuple(s.pretrain_window_size[:len(depths)])
        shift = tuple(s.use_shift[:len(depths)])
    return SwinTransformerV2(
        embed_dim=embed_dim, depths=depths, num_heads=heads,
        window_size=window, pretrain_window_size=pwin, use_shift=shift,
        out_indices=(len(depths) - 1,), drop_path_rate=s.drop_path_rate,
        use_checkpoint=s.use_checkpoint, remat_policy=s.remat_policy,
        scan_blocks=s.scan_blocks, resident_pad_max=s.resident_pad_max,
        frozen_stages=s.frozen_stages, attn_impl=resolve_attn_impl(cfg),
        in_chans=in_chans, dtype=dtype, generator=generator)


class TwoFrameDepthPose(nn.Module):
    """Shared encoder over both frames + twin-headed decoder.

    forward(frame1, frame2) with NHWC float frames -> dict with
    pred_d1/pred_d2 (B, H, W, 1), pred_r12/pred_r21 (B, 9),
    pred_t12/pred_t21 (B, 3); r21/t21 are None for decoder_v1. Train vs eval
    behaviour follows module.train() / module.eval().
    """

    def __init__(self, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.dtype = _model_dtype(cfg)
        plan = build_plan(cfg)
        self.encoder = _build_encoder(cfg, self.dtype, generator)
        kw = dict(max_depth=cfg.max_depth, num_deconv=plan.num_deconv,
                  num_filters=plan.num_filters,
                  deconv_kernels=plan.deconv_kernels,
                  num_upscale=plan.num_upscale, dtype=self.dtype)
        if cfg.decoder == "decoder_v1":
            self.decoder = DecoderV1(plan.channels_in,
                                     out_channels=plan.channels_out, **kw)
        elif cfg.decoder == "decoder_v2":
            self.decoder = DecoderV2(plan.channels_in,
                                     out_channels=plan.channels_out * 2, **kw)
        else:
            raise ValueError(f"unknown decoder '{cfg.decoder}'")

    def forward(self, frame1, frame2, sparse1=None, sparse2=None):
        del sparse1, sparse2  # RGB-only family
        # Interleave the two frames on the batch axis ((B,2,...)->(2B,...)),
        # as the JAX package does: windows of one pair stay adjacent.
        B = frame1.shape[0]
        frames = torch.stack([frame1, frame2], dim=1).to(self.dtype)
        frames = frames.reshape((2 * B,) + tuple(frames.shape[2:]))
        f = self.encoder(frames)[-1]
        f = f.reshape((B, 2) + tuple(f.shape[1:]))
        f1, f2 = f[:, 0], f[:, 1]
        d1, r12, t12, d2, r21, t21 = self.decoder(f1, f2)
        return {
            "pred_d1": d1, "pred_d2": d2,
            "pred_r12": r12, "pred_r21": r21,
            "pred_t12": t12, "pred_t21": t21,
        }


def require_device(device: Union[str, torch.device],
                   module: Optional[nn.Module] = None,
                   what: str = "mmde_tpu_torch") -> torch.device:
    """The check every entry point makes: `device` (default of the callers:
    the CUDA card) must exist - no silent CPU substitute - and `module`,
    when given, must already live on a device of that type."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what}: device is CUDA but no CUDA device is available; "
            "pass device='cpu' explicitly to run on the CPU")
    if module is not None:
        p = next(module.parameters(), None)
        if p is not None and p.device.type != device.type:
            raise ValueError(f"{what}: the model lives on {p.device}, not on "
                             f"{device}")
    return device


def build_model(cfg: ModelConfig, *,
                device: Union[str, torch.device] = "cuda",
                generator: Optional[torch.Generator] = None) -> nn.Module:
    """Model factory over the three families (`cfg.family`): two_frame
    (TwoFrameDepthPose), glpdepth_scale16 (Scale16TwoFrame: the fused
    out_p network, with sparse-depth fusion under `sparse_depth_input`),
    glpdepth (GLPDepth, single frame). The model is created on `device`,
    which defaults to the CUDA card: without one this raises rather than
    building on the CPU (tests pass device="cpu"). `generator` (a CPU
    generator) seeds the initialisation and the model's stochastic depth;
    None uses torch's global generator."""
    from mmde_tpu_torch.models.glpdepth import GLPDepth, Scale16TwoFrame
    family = {"glpdepth": GLPDepth, "glpdepth_scale16": Scale16TwoFrame
              }.get(cfg.family, TwoFrameDepthPose)
    device = require_device(device, what="build_model")
    if generator is not None:
        # torch's initialisers draw from the global generator: fork it,
        # seed the fork from `generator`, and leave the caller's stream alone
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(int(torch.randint(
                0, 2 ** 31 - 1, (1,), generator=generator)))
            model = family(cfg)
    else:
        model = family(cfg)
    return model.to(device)
