#!/usr/bin/env python
"""Inference entry points and folder CLI of the port.

    python -m mmde_tpu_torch.tools.infer --images ./photos --out ./depth_out \\
        [--config cfg.yaml] [--ckpt RUN/ckpt | --weights model.pth] [--flip] \\
        [--device cuda]

`build` -> `load_weights` (or `ckpt.io.restore_eval` of a training run's
checkpoints, the best-RMSE one first, as `--ckpt` does) -> `predict` is the
serving path: `predict` takes numpy frames and returns numpy predictions,
and is what a server or a smoke run calls, for every model family (the
single-frame GLPDepth takes one frame and returns `pred_d`; a model that
fuses sparse depth takes the sparse maps). The CLI pairs each image with
itself for the two-frame families (as the JAX package's tools/infer.py
does), feeds it alone to GLPDepth, and writes 16-bit depth PNGs;
it imports cv2 only inside main(). The first call on a CUDA device builds the
attention kernels into mmde_tpu_torch/_build/. MMDE_ATTN_W=auto (or an int),
read once at import as in the JAX package, serves the packed attention with
W windows per block (K5) where the JAX rule gives W > 1; MMDE_ATTN_GRID
changes only the backward, so serving is the same under each of its values
(see ops/window_attention_packed.py).
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Union

import numpy as np
import torch

from mmde_tpu_torch.ckpt import io
from mmde_tpu_torch.config import Config, ModelConfig, load_yaml
from mmde_tpu_torch.models.glpdepth import GLPDepth
from mmde_tpu_torch.models.two_frame import build_model
from mmde_tpu_torch.train.single_frame import make_single_forward
from mmde_tpu_torch.train.step import make_forward
from mmde_tpu_torch.train.tta import flip_average, flip_average_two_frame


def build(cfg: Union[ModelConfig, Config, str, None] = None, *,
          device: Union[str, torch.device] = "cuda",
          seed: int = 0) -> torch.nn.Module:
    """Build the model of `cfg` (a ModelConfig, a Config, a YAML path, or
    None for the defaults) on `device` in eval mode, initialised from
    `seed`. The default device is the CUDA card; there is no silent CPU
    substitute."""
    if cfg is None:
        cfg = Config()
    elif isinstance(cfg, str):
        cfg = load_yaml(cfg)
    if isinstance(cfg, Config):
        cfg = cfg.model
    gen = torch.Generator()
    gen.manual_seed(seed)
    return build_model(cfg, device=device, generator=gen).eval()


def load_weights(model: torch.nn.Module, path: str) -> None:
    """Load a state dict saved by torch.save (bare, or under 'model' /
    'state_dict' / 'model_state_dict') into `model`, strictly."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("model", "state_dict", "model_state_dict"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
            break
    model.load_state_dict(obj, strict=True)


def predict(model: torch.nn.Module, frame1: np.ndarray,
            frame2: Optional[np.ndarray] = None, *,
            sparse1: Optional[np.ndarray] = None,
            sparse2: Optional[np.ndarray] = None,
            flip_tta: bool = False) -> Dict[str, Optional[np.ndarray]]:
    """frames: (B, H, W, 3) uint8 (0..255) or float (0..1) numpy arrays.
    Returns the model's outputs as float32 numpy arrays: for the two-frame
    families pred_d1/pred_d2 (B, H, W, 1), pred_r12/pred_r21 (B, 9),
    pred_t12/pred_t21 (B, 3) (r21/t21 None for decoder_v1;
    glpdepth_scale16 adds out_p (B, 12)); for the single-frame GLPDepth
    (frame1 alone) pred_d (B, H, W, 1). sparse1 / sparse2: (B, H, W) sparse
    depth for a model built with sparse_depth_input (sparse2 defaults to
    sparse1), mirrored with the frames under `flip_tta`. Runs on the device
    the model lives on; uint8 frames are normalised there."""
    device = next(model.parameters()).device

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    if isinstance(model, GLPDepth):
        forward = make_single_forward(model)
        f = tensor(frame1)
        d = flip_average(forward, f) if flip_tta else forward(f)
        return {"pred_d": d.float().cpu().numpy()}
    f1, f2 = tensor(frame1), tensor(frame2)
    maps = {k: tensor(v) for k, v in (("sparse1", sparse1),
                                      ("sparse2", sparse2)) if v is not None}
    forward = make_forward(model)
    out = (flip_average_two_frame(forward, f1, f2, **maps) if flip_tta
           else forward(f1, f2, **maps))
    return {k: None if v is None else v.float().cpu().numpy()
            for k, v in out.items()}


_IMAGE_EXT = (".png", ".jpg", ".jpeg", ".bmp")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--images", required=True, help="folder of RGB images")
    p.add_argument("--out", required=True, help="output folder")
    p.add_argument("--config", default=None, help="YAML config")
    p.add_argument("--ckpt", default=None,
                   help="a training run's ckpt/ directory (best first)")
    p.add_argument("--weights", default=None, help="torch state dict (.pth)")
    p.add_argument("--flip", action="store_true", help="flip averaging")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import cv2  # only the CLI reads and writes image files

    cfg = load_yaml(args.config) if args.config else Config()
    model = build(cfg, device=args.device, seed=args.seed)
    if args.ckpt:
        epoch, kind = io.restore_eval(args.ckpt, model)
        print(f"restored {kind} checkpoint (epoch {epoch})")
    if args.weights:
        load_weights(model, args.weights)
    names = sorted(n for n in os.listdir(args.images)
                   if n.lower().endswith(_IMAGE_EXT))
    if not names:
        print("no images found")
        return
    os.makedirs(args.out, exist_ok=True)
    # 16-bit PNG scale: millimetres, 256 counts per metre for KITTI
    scale = 256.0 if cfg.data.dataset == "kitti" else 1000.0
    for i, name in enumerate(names):
        path = os.path.join(args.images, name)
        bgr = cv2.imread(path, cv2.IMREAD_COLOR)
        if bgr is None:
            raise FileNotFoundError(path)
        rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
        # the JAX package's ImageFolder: each side cut to a multiple of 32
        h, w = rgb.shape[:2]
        rgb = cv2.resize(rgb, (w // 32 * 32, h // 32 * 32))[None]
        if isinstance(model, GLPDepth):
            depth = predict(model, rgb, flip_tta=args.flip)["pred_d"]
        else:
            depth = predict(model, rgb, rgb, flip_tta=args.flip)["pred_d1"]
        stem = os.path.splitext(name)[0]
        cv2.imwrite(os.path.join(args.out, stem + ".png"),
                    np.clip(depth[0, ..., 0] * scale, 0, 65535
                            ).astype(np.uint16))
        print(f"[{i + 1}/{len(names)}] {name}")


if __name__ == "__main__":
    main()
