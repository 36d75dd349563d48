#!/usr/bin/env python
"""Evaluation CLI of the port.

    python -m mmde_tpu_torch.tools.eval --config cfg.yaml --ckpt RUN/ckpt \\
        [--synthetic] [--flip-tta] [--shift-window-tta] [--max-batches N] \\
        [--device cuda]

Counterpart of the JAX package's tools/eval.py: restores a checkpoint's
model (`ckpt.io.restore_eval`: the best-RMSE one when there is one, else
the newest epoch), runs the evaluation split one sample a batch with
optional flip and shift-window TTA (crops of CROP_HEIGHT pixels, half a
crop apart), and prints the metric table and the mean losses.
`--save-pngs` and `--save-viz` (depth PNGs, comparison panels) wait for
the port of utils/viz (ROADMAP M9) and raise until then. The two-frame
families over any encoder are evaluated (with sparse depth in the batches
where the model fuses it, flip TTA mirroring it with the frames); the
single-frame family has `train.single_frame.evaluate_single`. The default
device is the CUDA card: without one the run raises.
"""
from __future__ import annotations

import argparse
import itertools


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="mmde_tpu_torch evaluator")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--ckpt", type=str, default=None,
                   help="a training run's ckpt/ directory")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--flip-tta", action="store_true")
    p.add_argument("--shift-window-tta", action="store_true")
    p.add_argument("--save-pngs", type=str, default=None,
                   help="dir for 16-bit depth PNG export (not ported yet)")
    p.add_argument("--save-viz", type=str, default=None,
                   help="dir for comparison panels (not ported yet)")
    p.add_argument("--max-batches", type=int, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.save_pngs or args.save_viz:
        raise NotImplementedError(
            "--save-pngs / --save-viz need utils/viz, not ported yet "
            "(ROADMAP Queue A, M9)")

    from mmde_tpu_torch.ckpt import io
    from mmde_tpu_torch.config import Config, load_yaml
    from mmde_tpu_torch.data.loader import DataLoader
    from mmde_tpu_torch.tools.infer import build
    from mmde_tpu_torch.train.loop import (build_datasets, check_two_frame,
                                           validate)
    from mmde_tpu_torch.train.step import TrainState, make_eval_metrics_step
    from mmde_tpu_torch.utils.logging import display_result

    cfg = load_yaml(args.config) if args.config else Config()
    check_two_frame(cfg)
    model = build(cfg, device=args.device, seed=0)
    _, val_ds = build_datasets(cfg, args.synthetic)
    val_loader = DataLoader(val_ds, 1, shuffle=False, num_workers=2,
                            drop_last=False)
    restored = None
    if args.ckpt:
        epoch, kind = io.restore_eval(args.ckpt, model)
        restored = {"epoch": epoch, "kind": kind}
        print(f"restored {kind} checkpoint (epoch {epoch}) from {args.ckpt}")

    shift_window = cfg.data.crop_h if args.shift_window_tta else None
    if args.flip_tta:
        print("TTA: horizontal-flip averaging enabled")
    if args.shift_window_tta:
        print(f"TTA: shift-window over {shift_window}-px crops "
              "(two-frame composition)")
    tc = cfg.train
    metrics_fn = make_eval_metrics_step(
        model, dataset=cfg.data.dataset, decoder=cfg.model.decoder,
        lambda_rot=tc.loss_lambda1, lambda_trans=tc.loss_lambda2,
        min_depth_eval=cfg.eval.min_depth_eval,
        max_depth_eval=cfg.eval.max_depth_eval,
        do_kb_crop=cfg.data.do_kb_crop, kitti_crop=cfg.data.kitti_crop,
        flip_tta=args.flip_tta, shift_window=shift_window,
        device=args.device)
    batches = (itertools.islice(val_loader, args.max_batches)
               if args.max_batches else val_loader)
    result, losses = validate(metrics_fn, TrainState(model, None), batches,
                              cfg, args.device)
    print(display_result(result))
    print("losses:", {k: round(v, 5) for k, v in losses.items()})
    return {"metrics": result, "losses": losses, "restored": restored}


if __name__ == "__main__":
    main()
