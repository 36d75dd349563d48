"""Single-frame GLPDepth training and evaluation.

Counterpart of mmde_tpu/train/single_frame.py on one card:

  * `make_single_train_step`: the model (family "glpdepth") on the batch's
    image, the SiLog loss alone against its depth, backward and the
    optimizer update; step(state, batch) -> (new_state, {"loss_depth"}).
  * `make_single_forward`: eval-mode (B, H, W, 3) -> (B, H, W, 1) depth,
    no gradient recorded (what the TTA helpers call).
  * `evaluate_single`: the depth metric suite over an {image, depth}
    loader, per sample (the eval mask of the dataset), averaged, with flip
    and shift-window TTA (the flip applied inside each window).

The model and optimizer are updated in place, as in `train.step`; the
TrainState carries the step count and the generator dropout and drop-path
draw from. The JAX package's `mesh` and `donate` have no counterpart on
one card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch

from mmde_tpu_torch import metrics as M
from mmde_tpu_torch.config import Config
from mmde_tpu_torch.losses import silog_loss
from mmde_tpu_torch.models.two_frame import require_device
from mmde_tpu_torch.train.step import TrainState, _image
from mmde_tpu_torch.train.tta import flip_average, shift_window_eval


def make_single_train_step(model: torch.nn.Module,
                           optimizer: torch.optim.Optimizer, *,
                           silog_lambda: float = 0.5,
                           device: Union[str, torch.device] = "cuda"):
    """step(state, batch) -> (new_state, {"loss_depth": tensor}); batch keys
    image (B, H, W, 3) uint8 or float and depth (B, H, W), on the model's
    device, which runs in train mode. The model must live on `device`
    (default the CUDA card, which raises without one; tests pass
    device="cpu")."""
    require_device(device, model, "make_single_train_step")

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model.train()
        out = model(_image(batch["image"]))
        loss = silog_loss(out["pred_d"].squeeze(-1), batch["depth"],
                          silog_lambda)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return (dataclasses.replace(state, step=state.step + 1),
                {"loss_depth": loss.detach()})

    return step


def make_single_forward(model: torch.nn.Module):
    """Eval-mode (B, H, W, 3) -> (B, H, W, 1) depth forward, no gradient
    recorded: the attention kernels write their output alone."""
    model.eval()

    def forward(images: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(_image(images))["pred_d"]

    return forward


def evaluate_single(model: torch.nn.Module, state: Optional[TrainState],
                    loader, cfg: Config, *, flip_tta: bool = False,
                    shift_window_tta: bool = False,
                    shift_crop: Optional[int] = None,
                    device: Union[str, torch.device] = "cuda"
                    ) -> Dict[str, float]:
    """Mean depth metrics over an {image, depth} loader (numpy or tensor
    batches), each sample through the dataset's eval mask, with optional
    flip and shift-window TTA (crop `shift_crop`, default the image height;
    the flip inside each window)."""
    del state                           # the model is updated in place
    device = require_device(device, model, "evaluate_single")
    forward = make_single_forward(model)
    sums = {k: 0.0 for k in M.DEPTH_METRIC_NAMES}
    n = 0
    for batch in loader:
        img = torch.as_tensor(np.asarray(batch["image"])).to(device)
        gt = torch.as_tensor(np.asarray(batch["depth"])).to(device)
        base = ((lambda x: flip_average(forward, x)) if flip_tta
                else forward)
        if shift_window_tta:
            pred = shift_window_eval(base, img,
                                     crop=shift_crop or img.shape[1])
        else:
            pred = base(img)
        pred = pred.squeeze(-1)
        for b in range(pred.shape[0]):
            p, g, mask = M.eval_mask(
                cfg.data.dataset, pred[b], gt[b],
                min_depth_eval=cfg.eval.min_depth_eval,
                max_depth_eval=cfg.eval.max_depth_eval,
                do_kb_crop=cfg.data.do_kb_crop,
                kitti_crop=cfg.data.kitti_crop)
            for k, v in M.eval_depth_masked(p, g, mask).items():
                sums[k] += float(v)
            n += 1
    return {k: v / max(n, 1) for k, v in sums.items()}
