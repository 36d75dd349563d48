"""Pretrained-backbone loading.

Counterpart of mmde_tpu/ckpt/pretrained.py: the reference's
`encoder.init_weights(pretrained=...)` with SimMIM SwinV2 checkpoints
(models/model.py:50,68 -> checkpoint.py:318) and torchvision ResNets
(cnn_transformer.py:29,33). `load_pretrained` converts the file
(ckpt.torch_convert) and overlays it non-strictly onto the model's encoder
- `model.encoder`, or `model.net.encoder` for the Scale16TwoFrame adapter -
in place, printing the JAX function's report.
"""
from __future__ import annotations

import os
from typing import List, Tuple

import torch

from mmde_tpu_torch.config import ModelConfig
from mmde_tpu_torch.ckpt import torch_convert as tc


def load_pretrained(model: torch.nn.Module, cfg: ModelConfig, path: str,
                    rpe_interpolation: str = "geo", verbose: bool = True
                    ) -> Tuple[List[str], List[str], List[str]]:
    """Overlay the pretrained encoder weights of `path` onto `model` (on
    any device) and return (missing, unexpected, notes). A missing path
    prints and returns, as in the JAX package, with nothing loaded.

    Swin backbones (`"swin" in cfg.backbone`): the SwinV2 checkpoint's
    discrete relative-position tables are resampled to cfg.swin's windows
    (`rpe_interpolation`: "geo" or "bicubic"). Otherwise the file is a
    torchvision ResNet and goes into the encoder's trunk
    (`feature_extractor.backbone`), running statistics included."""
    if not path or not os.path.exists(path):
        if verbose and path:
            print(f"[pretrained] checkpoint not found: {path} (skipping)")
        return [], [], []
    sd = tc.load_torch_state_dict(path)
    # Scale16TwoFrame holds its network (and encoder) under `net`
    encoder = model.encoder if hasattr(model, "encoder") else \
        model.net.encoder
    if "swin" in cfg.backbone:
        dst_windows = dict(enumerate(cfg.swin.window_size))
        converted, report = tc.convert_swin(
            sd, dst_windows=dst_windows, rpe_interpolation=rpe_interpolation)
        missing, unexpected = tc.apply_pretrained(encoder, converted)
    else:
        trunk = encoder.feature_extractor.backbone
        converted, report = tc.convert_resnet(
            sd, multi_scale=hasattr(trunk, "feature3"))
        missing, unexpected = tc.apply_pretrained(trunk, converted)
    if verbose:
        print(f"[pretrained] loaded {path}: "
              f"{len(missing)} missing, {len(unexpected)} unexpected")
        for m in missing[:8]:
            print("  missing:", m)
        for u in unexpected[:8]:
            print("  unexpected:", u)
        for r in report[:8]:
            print("  note:", r)
    return missing, unexpected, report
