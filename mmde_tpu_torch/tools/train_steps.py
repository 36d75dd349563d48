#!/usr/bin/env python
"""Take a few train steps on a synthetic batch.

    python -m mmde_tpu_torch.tools.train_steps --steps 5 [--batch 2] \\
        [--config cfg.yaml | --backbone swin_large_v2] \\
        [--height 480 --width 640] [--seed 0] [--deterministic] \\
        [--device cuda]

Builds the model of the config (default: the flagship, swin_base_v2 +
decoder_v2 in bfloat16; `--backbone` swaps the flagship's encoder for
another swin variant at the same windows and depths, e.g. swin_large_v2,
whose first stage runs the head-split attention kernels) from a seed, draws
one synthetic batch (frames, valid depth, relative poses) from the same
seed, and takes N steps through `make_train_step` with the layer-decay AdamW
of `build_optimizer`, printing one JSON line per step. The first call on a
CUDA device builds the attention kernels into mmde_tpu_torch/_build/;
MMDE_ATTN_GRID=split in the environment takes the packed attention
backward's atomics-free dbias pass (slower; see
ops/window_attention_packed.py). The training loop proper (datasets,
validation, checkpoints) is a later slice; this entry is what a smoke run
and a profiler drive.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from mmde_tpu_torch.config import (Config, ModelConfig, SwinConfig,
                                   TrainConfig, load_yaml)
from mmde_tpu_torch.geometry import exp_so3
from mmde_tpu_torch.models.two_frame import build_model
from mmde_tpu_torch.train.optim import build_optimizer
from mmde_tpu_torch.train.step import TrainState, make_train_step


def flagship_config(dtype: str = "bfloat16", attn_impl: str = "cuda",
                    depths=(2, 2, 18, 2), batch_size: int = 2,
                    backbone: str = "swin_base_v2") -> Config:
    """The flagship: swin_base_v2 (windows 30/30/30/15, shift on stages 1-2,
    drop path 0.3, nothing rematerialised) + decoder_v2; `backbone` another
    swin variant in its place."""
    swin = SwinConfig(depths=tuple(depths), window_size=(30, 30, 30, 15),
                      pretrain_window_size=(12, 12, 12, 6),
                      use_shift=(True, True, False, False),
                      drop_path_rate=0.3, use_checkpoint=True,
                      remat_policy="none")
    model = ModelConfig(backbone=backbone, decoder="decoder_v2",
                        model_scale=32, max_depth=10.0, swin=swin,
                        dtype=dtype, attn_impl=attn_impl)
    return Config(model=model, train=TrainConfig(batch_size=batch_size))


def synthetic_batch(batch: int, height: int, width: int, seed: int,
                    device: Union[str, torch.device] = "cpu"
                    ) -> Dict[str, torch.Tensor]:
    """One batch with the train step's keys, drawn with numpy from `seed`:
    uint8 frames (smooth structure + noise), depth in (0.5, 9.5) with a
    fifth of the pixels invalid (0), small relative rotations (9-vector of
    the rotation matrix) and translations, both directions."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    out: Dict[str, np.ndarray] = {}
    for k in (1, 2):
        base = (127 + 80 * np.sin(xx / (17.0 + 3 * k) + yy / 29.0)
                )[None, :, :, None]
        noise = rng.integers(-40, 40, size=(batch, height, width, 3))
        out[f"image{k}"] = np.clip(base + noise, 0, 255).astype(np.uint8)
        depth = (5.0 + 4.5 * np.sin(xx / 53.0 + k) * np.cos(yy / 41.0)
                 )[None].repeat(batch, 0)
        depth = depth + rng.uniform(-0.4, 0.4, size=depth.shape)
        depth[rng.random(depth.shape) < 0.2] = 0.0
        out[f"depth{k}"] = depth.astype(np.float32)
    w = rng.normal(0.0, 0.05, size=(batch, 3))
    t = rng.normal(0.0, 0.1, size=(batch, 3))
    R12 = np.stack([exp_so3(wi) for wi in w])
    out["R12"] = R12.reshape(batch, 9).astype(np.float32)
    out["T12"] = t.astype(np.float32)
    R21 = np.transpose(R12, (0, 2, 1))
    out["R21"] = R21.reshape(batch, 9).astype(np.float32)
    out["T21"] = (-R21 @ t[..., None])[..., 0].astype(np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def build_trainer(cfg: Optional[Config] = None, *,
                  device: Union[str, torch.device] = "cuda", seed: int = 0,
                  steps_per_epoch: int = 100, deterministic: bool = False
                  ) -> Tuple[TrainState, callable]:
    """(state, step) for `cfg` (None: the flagship): the model built from
    `seed` on `device` (default: the CUDA card; raises without one), its
    layer-decay AdamW, and the train step. Drop-path and dropout draw from a
    generator on `device` seeded with `seed`."""
    cfg = cfg or flagship_config()
    init_gen = torch.Generator()
    init_gen.manual_seed(seed)
    model = build_model(cfg.model, device=device, generator=init_gen)
    tc = cfg.train
    optimizer, _ = build_optimizer(
        model, backbone=cfg.model.backbone, depths=cfg.model.swin.depths,
        max_lr=tc.max_lr, min_lr=tc.min_lr, weight_decay=tc.weight_decay,
        layer_decay=tc.layer_decay, steps_per_epoch=steps_per_epoch,
        epochs=tc.epochs, frozen_stages=cfg.model.swin.frozen_stages,
        device=device)
    step = make_train_step(model, optimizer, decoder=cfg.model.decoder,
                           lambda_rot=tc.loss_lambda1,
                           lambda_trans=tc.loss_lambda2,
                           silog_lambda=tc.silog_lambda,
                           deterministic=deterministic, device=device)
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(seed)
    return TrainState.create(model, optimizer, gen), step


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--batch", type=int, default=None,
                   help="frame pairs per step (default: the config's)")
    p.add_argument("--config", default=None, help="YAML config")
    p.add_argument("--backbone", default="swin_base_v2",
                   help="the flagship's encoder (without --config)")
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--deterministic", action="store_true",
                   help="eval-mode modules inside the step")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = (load_yaml(args.config) if args.config
           else flagship_config(backbone=args.backbone))
    batch_size = args.batch or cfg.train.batch_size
    state, step = build_trainer(cfg, device=args.device, seed=args.seed,
                                deterministic=args.deterministic)
    batch = synthetic_batch(batch_size, args.height, args.width, args.seed,
                            device=args.device)
    on_cuda = torch.device(args.device).type == "cuda"
    for _ in range(args.steps):
        t0 = time.time()
        state, aux = step(state, batch)
        if on_cuda:
            torch.cuda.synchronize()
        rec = {"step": state.step, "ms": (time.time() - t0) * 1e3}
        rec.update({k: float(v) for k, v in aux.items()})
        if on_cuda:
            rec["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
