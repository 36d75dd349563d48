#!/usr/bin/env python
"""Evaluation CLI of the port.

    python -m mmde_tpu_torch.tools.eval --config cfg.yaml --ckpt RUN/ckpt \\
        [--synthetic] [--flip-tta] [--shift-window-tta] [--max-batches N] \\
        [--save-pngs DIR] [--save-viz DIR] [--device cuda]

Counterpart of the JAX package's tools/eval.py: restores a checkpoint's
model (`ckpt.io.restore_eval`: the best-RMSE one when there is one, else
the newest epoch), runs the evaluation split one sample a batch with
optional flip and shift-window TTA (crops of CROP_HEIGHT pixels, half a
crop apart), and prints the metric table and the mean losses. Then, as the
reference evaluators export (test_void_with_custom_network.py:85-120),
`--save-pngs DIR` writes each sample's two predicted depth maps as 16-bit
PNGs (`NNNNN_d1.png`, `NNNNN_d2.png`: millimetres, 1/256 m for KITTI,
truncated) and its ground-truth and predicted poses (`pose_NNNNN.txt`);
`--save-viz DIR` writes a comparison panel per sample (frames, ground
truth, predictions, error maps; named after the sample's file) and the
same pose file (utils.viz). The two-frame families over any encoder are
evaluated (with sparse depth in the batches where the model fuses it,
flip TTA mirroring it with the frames; the model is built for the
evaluation batches, with or without sparse depth); the single-frame family
has `train.single_frame.evaluate_single`. The default device is the CUDA
card: without one the run raises.
"""
from __future__ import annotations

import argparse
import itertools
import os


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="mmde_tpu_torch evaluator")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--ckpt", type=str, default=None,
                   help="a training run's ckpt/ directory")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--flip-tta", action="store_true")
    p.add_argument("--shift-window-tta", action="store_true")
    p.add_argument("--save-pngs", type=str, default=None,
                   help="dir for 16-bit depth PNG export")
    p.add_argument("--save-viz", type=str, default=None,
                   help="dir for comparison panels")
    p.add_argument("--max-batches", type=int, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from mmde_tpu_torch.ckpt import io
    from mmde_tpu_torch.config import Config, load_yaml
    from mmde_tpu_torch.data.loader import DataLoader
    from mmde_tpu_torch.tools.infer import build
    from mmde_tpu_torch.train.loop import (build_datasets,
                                           carries_sparse_depth,
                                           check_two_frame, validate)
    from mmde_tpu_torch.train.step import (TrainState, make_eval_metrics_step,
                                           make_eval_step)
    from mmde_tpu_torch.utils.logging import display_result

    cfg = load_yaml(args.config) if args.config else Config()
    check_two_frame(cfg)
    _, val_ds = build_datasets(cfg, args.synthetic)
    model = build(cfg, device=args.device, seed=0,
                  sparse_depth=carries_sparse_depth(val_ds))
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

    def batches():
        return (itertools.islice(val_loader, args.max_batches)
                if args.max_batches else val_loader)

    state = TrainState(model, None)
    result, losses = validate(metrics_fn, state, batches(), cfg, args.device)
    print(display_result(result))
    print("losses:", {k: round(v, 5) for k, v in losses.items()})
    written = []
    if args.save_pngs or args.save_viz:
        eval_fn = make_eval_step(
            model, decoder=cfg.model.decoder, lambda_rot=tc.loss_lambda1,
            lambda_trans=tc.loss_lambda2, flip_tta=args.flip_tta,
            shift_window=shift_window, device=args.device)
        written = save_artifacts(eval_fn, state, batches(), cfg,
                                 args.save_pngs, args.save_viz, args.device)
    return {"metrics": result, "losses": losses, "restored": restored,
            "written": written}


def save_artifacts(eval_fn, state, batches, cfg, pngs_dir, viz_dir,
                   device) -> list:
    """The --save-pngs / --save-viz files of every batch (one sample each),
    from the eval step's predictions; returns the paths written."""
    from mmde_tpu_torch.train.loop import batch_tensors
    from mmde_tpu_torch.utils import viz

    written = []
    for n, batch in enumerate(batches):
        preds, _ = eval_fn(state, batch_tensors(batch, device))
        d1, d2 = (preds[k][0, ..., 0].float().cpu().numpy()
                  for k in ("pred_d1", "pred_d2"))
        pose = (batch["R12"][0], preds["pred_r12"][0].float().cpu().numpy(),
                batch["T12"][0], preds["pred_t12"][0].float().cpu().numpy())
        if pngs_dir:
            os.makedirs(pngs_dir, exist_ok=True)
            for tag, d in (("d1", d1), ("d2", d2)):
                path = os.path.join(pngs_dir, f"{n:05d}_{tag}.png")
                viz.save_depth_png16(path, d, cfg.data.dataset)
                written.append(path)
            written.append(viz.save_pose_txt(pngs_dir, f"pose_{n:05d}",
                                             *pose))
        if viz_dir:
            name = batch.get("filename", [f"sample_{n}"])[0]
            written.append(viz.save_comparison_panel(
                viz_dir, str(name).replace("/", "_"), batch["image1"][0],
                batch["image2"][0], batch["depth1"][0], batch["depth2"][0],
                d1, d2))
            written.append(viz.save_pose_txt(viz_dir, f"pose_{n:05d}",
                                             *pose))
    return written


if __name__ == "__main__":
    main()
