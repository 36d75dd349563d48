"""Train / eval steps and the TrainState container.

Counterpart of mmde_tpu/train/step.py on one card: `_image` (device-side
normalisation of uint8-shipped frames), `make_forward`, `make_train_step`
(forward, loss, backward, optimizer update as one Python function; PyTorch
runs it eagerly, there is nothing to jit), `make_eval_step` and
`make_eval_metrics_step`. The JAX package's `mesh`, `fused_collectives` and
`donate` arguments concern a device mesh and XLA buffer donation and have no
counterpart on one card (data-parallel training is a later slice).

The model and the optimizer are updated in place; a TrainState names them
together with the step count and the generator that drop-path and dropout
draw from. Loss values stay tensors on the device: nothing in a step waits
for the host.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from mmde_tpu_torch import metrics as M
from mmde_tpu_torch.losses import total_loss
from mmde_tpu_torch.models.two_frame import require_device
from mmde_tpu_torch.nn.layers import set_generator
from mmde_tpu_torch.train.tta import (flip_average_two_frame,
                                      shift_window_eval_two_frame)

Batch = Dict[str, torch.Tensor]


def _image(x: torch.Tensor) -> torch.Tensor:
    """uint8 frames -> float32 / 255 on the tensor's device (4x fewer
    host-to-device bytes than shipping floats); float frames pass through."""
    if x.dtype == torch.uint8:
        return x.float() / 255.0
    return x


@dataclasses.dataclass(frozen=True)
class TrainState:
    """What a training run carries from step to step. `model` and
    `optimizer` are mutated by the step; `step` counts updates made."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    generator: Optional[torch.Generator] = None

    @classmethod
    def create(cls, model: torch.nn.Module,
               optimizer: torch.optim.Optimizer,
               generator: Optional[torch.Generator] = None) -> "TrainState":
        """`generator` (any device; None = torch's global one) becomes the
        source of every drop-path and dropout draw of `model`."""
        set_generator(model, generator)
        return cls(model=model, optimizer=optimizer, step=0,
                   generator=generator)


def _sparse_kwargs(batch: Batch) -> dict:
    if "sparse_depth1" not in batch:
        return {}
    return {"sparse1": batch["sparse_depth1"],
            "sparse2": batch.get("sparse_depth2", batch["sparse_depth1"])}


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    *, decoder: str, lambda_rot: float, lambda_trans: float,
                    silog_lambda: float = 0.5, deterministic: bool = False,
                    device: Union[str, torch.device] = "cuda"
                    ) -> Callable[[TrainState, Batch], Tuple[TrainState, dict]]:
    """Build the train step.

    step(state, batch) -> (new_state, dict of loss scalars: loss_total,
    loss_depth, loss_rotation, loss_translation, on the device).
    batch keys: image1, image2 (B, H, W, 3) uint8 or float, depth1, depth2
    (B, H, W), R12, T12 [, R21, T21, pose_valid], tensors on the model's
    device.

    deterministic=True applies the model in eval mode inside the train step:
    dropout / drop-path off, BatchNorm normalises with its running
    statistics and does not update them. Gradients still flow: it exists so
    that a whole step can be compared across implementations whose random
    bits differ; production training keeps the default.

    The model must live on `device`, which defaults to the CUDA card and
    raises without one (tests pass device="cpu").
    """
    require_device(device, model, "make_train_step")

    def train_step(state: TrainState, batch: Batch):
        model.train(not deterministic)
        out = model(_image(batch["image1"]), _image(batch["image2"]),
                    **_sparse_kwargs(batch))
        loss, aux = total_loss(out, batch, decoder=decoder,
                               lambda_rot=lambda_rot,
                               lambda_trans=lambda_trans,
                               silog_lambda=silog_lambda)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        aux = {k: v.detach() for k, v in aux.items()}
        return dataclasses.replace(state, step=state.step + 1), aux

    return train_step


def make_eval_step(model: torch.nn.Module, *, decoder: str,
                   lambda_rot: float, lambda_trans: float,
                   silog_lambda: float = 0.5, flip_tta: bool = False,
                   shift_window: Optional[int] = None,
                   shift_stride: Optional[int] = None,
                   device: Union[str, torch.device] = "cuda"):
    """Eval forward + losses: step(state, batch) -> (preds, loss aux).

    flip_tta: mirror the frames (and the sparse depth maps, where the
    batch has them) horizontally, run again, and average the un-mirrored
    depth maps; pose predictions come from the plain pass (mirroring
    changes the true pose). shift_window: slide (H x
    shift_window) crops across the width, `shift_stride` apart (None: half
    a crop), and recompose by coverage averaging (train/tta.py); a no-op
    when the frames are not wider than the crop. Composable with flip_tta
    (the flip applies over the composition)."""
    require_device(device, model, "make_eval_step")

    def full_forward(f1, f2, kwargs):
        if shift_window and f1.shape[2] > shift_window:
            if kwargs:
                raise NotImplementedError(
                    "shift-window TTA with sparse-depth inputs is not "
                    "supported (nor in the JAX package)")
            return shift_window_eval_two_frame(
                model, f1, f2, crop=shift_window, stride=shift_stride)
        return model(f1, f2, **kwargs)

    def eval_step(state: TrainState, batch: Batch):
        del state                       # the model is updated in place
        model.eval()
        kwargs = _sparse_kwargs(batch)
        with torch.inference_mode():
            f1, f2 = _image(batch["image1"]), _image(batch["image2"])
            if flip_tta:
                # sparse depth mirrored with the frames
                out = flip_average_two_frame(
                    lambda a, b, **k: full_forward(a, b, k), f1, f2,
                    **kwargs)
            else:
                out = full_forward(f1, f2, kwargs)
            _, aux = total_loss(out, batch, decoder=decoder,
                                lambda_rot=lambda_rot,
                                lambda_trans=lambda_trans,
                                silog_lambda=silog_lambda)
        return out, aux

    return eval_step


def make_eval_metrics_step(model: torch.nn.Module, *, dataset: str,
                           decoder: str, lambda_rot: float,
                           lambda_trans: float, silog_lambda: float = 0.5,
                           min_depth_eval: float, max_depth_eval: float,
                           do_kb_crop: bool = True, kitti_crop=None,
                           flip_tta: bool = False,
                           shift_window: Optional[int] = None,
                           shift_stride: Optional[int] = None,
                           device: Union[str, torch.device] = "cuda"):
    """Eval forward + PER-SAMPLE metric suite:
    step(state, batch) -> (metrics dict of (B,) vectors, loss aux scalars).
    Metrics are per sample, matching the batch-size-1 validation protocol;
    the host averages them, masking padded tail samples by weight."""
    inner = make_eval_step(model, decoder=decoder, lambda_rot=lambda_rot,
                           lambda_trans=lambda_trans,
                           silog_lambda=silog_lambda, flip_tta=flip_tta,
                           shift_window=shift_window,
                           shift_stride=shift_stride, device=device)

    def metrics_step(state: TrainState, batch: Batch):
        preds, aux = inner(state, batch)
        with torch.inference_mode():
            pred_c, gt_c, mask = M.eval_mask(
                dataset, preds["pred_d1"].squeeze(-1), batch["depth1"],
                min_depth_eval=min_depth_eval, max_depth_eval=max_depth_eval,
                do_kb_crop=do_kb_crop, kitti_crop=kitti_crop)
            depth_m = M.eval_depth_masked_per_sample(pred_c, gt_c, mask)
            pose_m = M.eval_pose_per_sample(
                {"R12": preds["pred_r12"], "T12": preds["pred_t12"],
                 "R21": preds.get("pred_r21"), "T21": preds.get("pred_t21")},
                {"R12": batch["R12"], "T12": batch["T12"],
                 "R21": batch.get("R21"), "T21": batch.get("T21")})
        return {**depth_m, **pose_m}, aux

    return metrics_step


def make_forward(model):
    """Plain inference forward (for TTA / serving): eval mode, no gradient
    recorded, so the attention kernel writes its output alone.

    forward(frame1, frame2, **maps) takes NHWC tensors on the model's
    device, uint8 or float (and, for a model that fuses sparse depth,
    sparse1 / sparse2 maps), and returns the model's output dict."""
    model.eval()

    def forward(frame1: torch.Tensor, frame2: torch.Tensor, **maps):
        with torch.inference_mode():
            return model(_image(frame1), _image(frame2), **maps)

    return forward
