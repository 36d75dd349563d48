"""Training loop: epochs, validation, checkpoints, logging.

Counterpart of mmde_tpu/train/loop.py on one card: `build_datasets`,
`validate` and `train` - the poly LR schedule inside the optimizer, one
train step per batch (forward, loss, backward, update), batches copied to
the device ahead of the step (`data.loader.device_prefetch`), per-sample
validation metrics, a checkpoint every `save_freq` epochs and the best
validation RMSE kept apart (`ckpt.io`), scalars and logs.txt in the run's
log directory, for the two-frame families over any encoder (sparse depth
in the batches where the model fuses it), on the synthetic sets or the
VOID, NYU, KITTI and mixed readers of data/. Only the batches' arrays go
to the device (VOID's file names stay on the host). Data-parallel training
(the JAX package's mesh) is ROADMAP M8.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import time
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from mmde_tpu_torch import metrics as M
from mmde_tpu_torch.ckpt import io
from mmde_tpu_torch.config import Config
from mmde_tpu_torch.data.loader import DataLoader, device_prefetch
from mmde_tpu_torch.models.two_frame import build_model, require_device
from mmde_tpu_torch.train.optim import build_optimizer
from mmde_tpu_torch.train.step import (TrainState, make_eval_metrics_step,
                                       make_train_step)
from mmde_tpu_torch.utils.logging import (AverageMeter, ScalarWriter,
                                          display_result, log_args_to_txt)

METRIC_NAMES = M.ALL_METRIC_NAMES
LOSS_NAMES = ("loss_total", "loss_depth", "loss_rotation", "loss_translation")


def build_datasets(cfg: Config, synthetic: bool = False):
    """(train, val) datasets of cfg.data.dataset, as the JAX package's
    build_datasets picks them:

      * "synthetic_learnable": the convergence gate's data (depth cued in
        the red channel, 256 or more training samples from seed 1, a
        held-out draw of 8 from seed 7);
      * "synthetic" (or any dataset with `synthetic`): 64 or more samples,
        8 held out;
      * "void": VoidV3 over the release under cfg.data.data_path, its lists
        and calibration.json in cfg.data.void_meta_dir (default
        data_path/meta); sparse depth is not loaded, as in the JAX loop
        (a completion model then trains as the RGB model, as there);
      * "nyudepthv2": NYUDepthV2Pairs (scene-held-out test split);
      * "kitti": KITTIEigen in the unified two-frame schema (self-paired,
        identity pose);
      * "mixed": NYU pairs + KITTI + VOID in the unified schema, every
        source whose root exists under data_path joining the mix.

    A model built for sparse depth input (cfg.model.sparse_depth_input)
    gets the synthetic sets with their VIO-style sparse depth maps (~5 %
    of the valid pixels), which the JAX package's loop leaves out."""
    d, u8 = cfg.data, cfg.data.ship_uint8
    sp = cfg.model.sparse_depth_input
    crop = (d.crop_h, d.crop_w)
    if d.dataset == "synthetic_learnable":
        from mmde_tpu_torch.data.synthetic import SyntheticTwoFrameDataset
        train = SyntheticTwoFrameDataset(
            num_samples=max(256, 8 * cfg.train.batch_size),
            height=d.crop_h, width=d.crop_w, max_depth=cfg.model.max_depth,
            seed=1, depth_cue=True, uint8_images=u8, sparse_depth=sp)
        val = SyntheticTwoFrameDataset(
            num_samples=8, height=d.crop_h, width=d.crop_w,
            max_depth=cfg.model.max_depth, seed=7, depth_cue=True,
            uint8_images=u8, sparse_depth=sp)
        return train, val
    if synthetic or d.dataset == "synthetic":
        from mmde_tpu_torch.data.synthetic import SyntheticTwoFrameDataset
        # a few print windows an epoch at the configured batch size
        train = SyntheticTwoFrameDataset(
            num_samples=max(64, 24 * cfg.train.batch_size), height=d.crop_h,
            width=d.crop_w, max_depth=cfg.model.max_depth, uint8_images=u8,
            sparse_depth=sp)
        val = SyntheticTwoFrameDataset(
            num_samples=8, height=d.crop_h, width=d.crop_w,
            max_depth=cfg.model.max_depth, seed=7, uint8_images=u8,
            sparse_depth=sp)
        return train, val
    fn = os.path.join(d.data_path, "filenames")
    meta = d.void_meta_dir or os.path.join(d.data_path, "meta")

    def void(is_train: bool):
        from mmde_tpu_torch.data.void_v3 import VoidV3
        return VoidV3(d.data_path,
                      os.path.join(meta, ("train" if is_train else "test")
                                   + "_image.txt"),
                      os.path.join(meta, "calibration.json"),
                      is_train=is_train, crop_size=crop,
                      image_interval_range=d.image_interval_range,
                      imu_max_len=d.imu_max_len)

    if d.dataset == "void":
        return void(True), void(False)
    if d.dataset == "nyudepthv2":
        from mmde_tpu_torch.data.datasets import NYUDepthV2Pairs
        return (NYUDepthV2Pairs(d.data_path, fn, True, crop),
                NYUDepthV2Pairs(d.data_path, fn, False, crop))
    if d.dataset == "kitti":
        from mmde_tpu_torch.data.datasets import KITTIEigen
        from mmde_tpu_torch.data.mixed import UnifiedTwoFrame
        return tuple(UnifiedTwoFrame(KITTIEigen(d.data_path, fn, t, crop),
                                     "single_frame", crop, 0)
                     for t in (True, False))
    if d.dataset == "mixed":
        from mmde_tpu_torch.data.datasets import KITTIEigen, NYUDepthV2Pairs
        from mmde_tpu_torch.data.mixed import MixedDataset, UnifiedTwoFrame
        train_sources, val_sources = [], []
        for root, make, kind, dataset_id in (
                ("nyu_depth_v2",
                 lambda t: NYUDepthV2Pairs(d.data_path, fn, t, crop),
                 "two_frame", 0),
                ("kitti", lambda t: KITTIEigen(d.data_path, fn, t, crop),
                 "single_frame", 1),
                ("void_release", void, "two_frame_pose", 2)):
            if not os.path.isdir(os.path.join(d.data_path, root)):
                continue
            train_sources.append(UnifiedTwoFrame(make(True), kind, crop,
                                                 dataset_id))
            val_sources.append(UnifiedTwoFrame(make(False), kind, crop,
                                               dataset_id))
        if not train_sources:
            raise FileNotFoundError(
                f"no dataset roots found under {d.data_path}")
        return (MixedDataset(train_sources, seed=cfg.train.seed),
                MixedDataset(val_sources, seed=cfg.train.seed + 1))
    raise ValueError(f"unknown dataset '{d.dataset}'")


def ship_uint8(datasets) -> None:
    """What cfg.data.ship_uint8 asks of `train`: switch every dataset's
    augmentation policy to uint8 output (4x fewer host-to-device bytes; the
    steps normalise on the device), as the JAX loop does for the datasets
    that have a policy."""
    for ds in datasets:
        if hasattr(ds, "policy"):
            ds.policy = dataclasses.replace(ds.policy, output_dtype="uint8")


def check_two_frame(cfg: Config) -> None:
    """Raise for a model family the two-frame loop and eval cannot drive:
    family "glpdepth" takes one frame (train.single_frame)."""
    if cfg.model.family == "glpdepth":
        raise ValueError(
            "family 'glpdepth' is single-frame: train it with "
            "train.single_frame.make_single_train_step and evaluate it with "
            "evaluate_single; the loop and the eval CLI take two frames")


def carries_sparse_depth(dataset) -> bool:
    """Whether the dataset's samples carry sparse depth maps, read off its
    first sample as the JAX loop reads it off a sample batch."""
    return "sparse_depth1" in dataset[0]


def build_state(cfg: Config, steps_per_epoch: int,
                device: Union[str, torch.device] = "cuda",
                sparse_depth: bool = True) -> Tuple[TrainState, callable]:
    """(TrainState, LR schedule) of a fresh run: the model of cfg.model
    initialised from cfg.train.seed on `device` for batches with or
    without sparse depth (`sparse_depth`, see `build_model`), the
    pretrained backbone of cfg.model.swin.pretrained overlaid when that
    file exists (`ckpt.pretrained.load_pretrained`: a missing file is
    skipped with a message, as in the JAX loop), its layer-decay AdamW
    with the poly schedule over cfg.train.epochs x `steps_per_epoch`, and
    a generator on `device` seeded with cfg.train.seed + 1 for drop-path
    and dropout (the JAX TrainState's rng)."""
    init_gen = torch.Generator()
    init_gen.manual_seed(cfg.train.seed)
    model = build_model(cfg.model, device=device, generator=init_gen,
                        sparse_depth=sparse_depth)
    if cfg.model.swin.pretrained:
        from mmde_tpu_torch.ckpt.pretrained import load_pretrained
        load_pretrained(model, cfg.model, cfg.model.swin.pretrained)
    tc = cfg.train
    optimizer, schedule = build_optimizer(
        model, backbone=cfg.model.backbone, depths=cfg.model.swin.depths,
        max_lr=tc.max_lr, min_lr=tc.min_lr, weight_decay=tc.weight_decay,
        layer_decay=tc.layer_decay, steps_per_epoch=steps_per_epoch,
        epochs=tc.epochs, frozen_stages=cfg.model.swin.frozen_stages,
        device=device)
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(tc.seed + 1)
    return TrainState.create(model, optimizer, gen), schedule


def batch_tensors(batch: dict, device: Union[str, torch.device]
                  ) -> Dict[str, torch.Tensor]:
    """A host batch's arrays as tensors on `device` (file names stay)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items() if isinstance(v, np.ndarray)}


def validate(metrics_step, state, val_loader, cfg: Config,
             device: Union[str, torch.device] = "cuda"
             ) -> Tuple[Dict[str, float], Dict[str, float]]:
    """Full eval pass with per-sample metrics (the batch-size-1 protocol):
    returns (mean of every metric over the samples, mean of the loss aux).
    The per-batch results stay on the device until the pass ends and come
    back in one transfer."""
    device = torch.device(device)
    pending = []
    for batch in val_loader:
        arrays = batch_tensors(batch, device)
        per_sample, aux = metrics_step(state, arrays)
        pending.append((arrays["image1"].shape[0], per_sample, aux))
    if not pending:
        return ({k: 0.0 for k in METRIC_NAMES},
                {k: 0.0 for k in LOSS_NAMES[1:]})
    flat = torch.cat([torch.cat([ps[k].float().reshape(-1)
                                 for k in METRIC_NAMES]
                                + [aux[k].float().reshape(1)
                                   for k in LOSS_NAMES[1:]])
                      for _, ps, aux in pending]).cpu().numpy()
    sums = {k: 0.0 for k in METRIC_NAMES}
    loss_meters = {k: AverageMeter() for k in LOSS_NAMES[1:]}
    n_samples, at = 0, 0
    for B, _, _ in pending:
        for k in METRIC_NAMES:
            sums[k] += float(np.sum(flat[at:at + B]))
            at += B
        for k in LOSS_NAMES[1:]:
            loss_meters[k].update(float(flat[at]), B)
            at += 1
        n_samples += B
    result = {k: v / max(n_samples, 1) for k, v in sums.items()}
    return result, {k: m.avg for k, m in loss_meters.items()}


def train(cfg: Config, *, synthetic: bool = False,
          log_dir: Optional[str] = None,
          max_steps_per_epoch: Optional[int] = None,
          prestage_batches: int = 0,
          device: Union[str, torch.device] = "cuda") -> Dict[str, float]:
    """Run the training job on `device` (default: the CUDA card; raises
    without one); returns the last validation metrics.

    cfg.train.resume_from: "auto" resumes from the newest checkpoint in
    this run's log_dir/ckpt (a fresh start when there is none), a path
    resumes from the newest checkpoint in that directory; the epoch after
    the restored one comes next, and the optimizer's update count, the step
    and the drop-path generator go on from where they were saved.

    prestage_batches > 0: copy that many batches to the device before the
    first epoch and cycle them (a measurement mode: the host producer
    leaves the epoch; every epoch then trains on the same batches).

    The loop drives the two-frame families (two_frame, glpdepth_scale16);
    the single-frame GLPDepth trains through train.single_frame, as in the
    JAX package, whose loop takes two frames too."""
    check_two_frame(cfg)
    device = require_device(device, what="train")
    log_dir = log_dir or os.path.join(cfg.log_dir,
                                      time.strftime("%m%d_%H%M%S"))
    os.makedirs(log_dir, exist_ok=True)
    writer = ScalarWriter(log_dir)
    log_txt = os.path.join(log_dir, "logs.txt")
    log_args_to_txt(log_txt, cfg)
    ckpt_dir = os.path.join(log_dir, "ckpt")

    train_ds, val_ds = build_datasets(cfg, synthetic)
    if cfg.data.ship_uint8:
        ship_uint8((train_ds, val_ds))
    train_loader = DataLoader(train_ds, cfg.train.batch_size, shuffle=True,
                              num_workers=cfg.data.workers, drop_last=True,
                              seed=cfg.train.seed)
    val_loader = DataLoader(val_ds, 1, shuffle=False,
                            num_workers=min(cfg.data.workers, 2),
                            drop_last=False)
    steps_per_epoch = len(train_loader)
    if max_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, max_steps_per_epoch)
    state, schedule = build_state(cfg, steps_per_epoch, device,
                                  carries_sparse_depth(train_ds))
    model, optimizer = state.model, state.optimizer
    tc = cfg.train
    step_fn = make_train_step(model, optimizer, decoder=cfg.model.decoder,
                              lambda_rot=tc.loss_lambda1,
                              lambda_trans=tc.loss_lambda2,
                              silog_lambda=tc.silog_lambda, device=device)
    eval_fn = make_eval_metrics_step(
        model, dataset=cfg.data.dataset, decoder=cfg.model.decoder,
        lambda_rot=tc.loss_lambda1, lambda_trans=tc.loss_lambda2,
        silog_lambda=tc.silog_lambda,
        min_depth_eval=cfg.eval.min_depth_eval,
        max_depth_eval=cfg.eval.max_depth_eval,
        do_kb_crop=cfg.data.do_kb_crop, kitti_crop=cfg.data.kitti_crop,
        device=device)

    start_epoch = 1
    if tc.resume_from == "auto":
        if io.latest_epoch(ckpt_dir) is not None:
            state, resumed = io.restore(ckpt_dir, state)
            start_epoch = resumed + 1
            print(f"auto-resumed from epoch {resumed}")
    elif tc.resume_from:
        state, resumed = io.restore(tc.resume_from, state)
        start_epoch = resumed + 1
        print(f"resumed from epoch {resumed} ({tc.resume_from})")

    best = io.BestTracker(ckpt_dir)
    last_val: Dict[str, float] = {}
    epoch_losses = []
    staged: list = []
    for epoch in range(start_epoch, tc.epochs + 1):
        meters = {k: AverageMeter() for k in LOSS_NAMES}
        # The loss scalars stay on the device between print points and
        # come back in one transfer (drain): a fetch each step would make
        # the host wait for the card every step.
        pending = []
        drain_t0 = None
        rate = 0.0

        def drain():
            nonlocal drain_t0, rate
            if not pending:
                return
            vals = torch.stack([torch.stack([a[k].float()
                                             for k in LOSS_NAMES])
                                for a in pending]).cpu().tolist()
            now = time.perf_counter()
            for row in vals:
                for k, v in zip(LOSS_NAMES, row):
                    meters[k].update(v, tc.batch_size)
            if drain_t0 is not None and now > drain_t0:
                rate = tc.batch_size * len(vals) / (now - drain_t0)
            drain_t0 = now
            pending.clear()

        if prestage_batches:
            if not staged:
                for b in device_prefetch(iter(train_loader), device):
                    staged.append(b)
                    if len(staged) >= prestage_batches:
                        break
            batches = itertools.islice(itertools.cycle(staged),
                                       len(train_loader))
        else:
            batches = device_prefetch(iter(train_loader), device)
        for i, batch in enumerate(batches):
            if max_steps_per_epoch and i >= max_steps_per_epoch:
                break
            arrays = {k: v for k, v in batch.items()
                      if isinstance(v, torch.Tensor)}
            state, aux = step_fn(state, arrays)
            pending.append(aux)
            if i % tc.print_freq == 0:
                drain()
                lr = schedule(optimizer.count - 1)
                line = (f"Epoch [{epoch}/{tc.epochs}] step {i} "
                        f"loss {meters['loss_total'].avg:.4f} "
                        f"(d {meters['loss_depth'].avg:.4f} "
                        f"R {meters['loss_rotation'].avg:.4f} "
                        f"T {meters['loss_translation'].avg:.4f}) "
                        f"lr {lr:.2e} "
                        f"{rate:.1f} img/s")
                print(line)
                with open(log_txt, "a") as f:
                    f.write(line + "\n")
        if hasattr(batches, "close"):
            batches.close()             # stops the prefetch thread
        drain()

        for k, m in meters.items():
            writer.add_scalar(f"train/{k}", m.avg, epoch)
        epoch_losses.append(meters["loss_total"].avg)

        if tc.save_model and epoch % tc.save_freq == 0:
            io.save_epoch(ckpt_dir, state, epoch)

        if epoch % tc.val_freq == 0:
            result, losses = validate(eval_fn, state, val_loader, cfg,
                                      device)
            last_val = result
            print(display_result(result))
            with open(log_txt, "a") as f:
                f.write(display_result(result))
            for k, v in result.items():
                writer.add_scalar(f"val/{k}", v, epoch)
            for k, v in losses.items():
                writer.add_scalar(f"val/{k}", v, epoch)
            if tc.save_model:
                best.update(state, epoch, result["rmse"])

    _plot_losses(epoch_losses, log_dir)
    writer.close()
    return last_val


def _plot_losses(epoch_losses: list, log_dir: str) -> None:
    """The end-of-training loss curve, Train_Losses.png, where matplotlib
    imports (the card machine has none)."""
    try:
        import matplotlib
    except ImportError:
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    plt.figure()
    plt.plot(range(1, len(epoch_losses) + 1), epoch_losses, label="avg")
    plt.xlabel("epoch")
    plt.ylabel("train loss")
    plt.legend()
    plt.savefig(os.path.join(log_dir, "Train_Losses.png"))
    plt.close()
