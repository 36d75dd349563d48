"""Evaluation metrics: depth suite, eval crops, pose MSE + cycle consistency.

Counterpart of mmde_tpu/metrics.py:
  - the depth suite (d1/d2/d3, abs_rel, sq_rel, rmse, rmse_log, log10,
    silog) over valid pixels, whole-batch and per-sample;
  - `eval_mask`: inf/nan clamp of the prediction, min/max valid mask, the
    KITTI garg/eigen crops and the NYU eval crop (rows 45:471, cols 41:601);
  - pose MSEs plus the R12 R21 = I and T12 + R12 T21 = 0 identity checks.

The on-device versions keep static shapes (`torch.where` reductions);
`eval_depth_np` is the numpy form with boolean-indexed inputs, for final
reporting and as an oracle.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

DEPTH_METRIC_NAMES = (
    "d1", "d2", "d3", "abs_rel", "sq_rel", "rmse", "rmse_log", "log10", "silog",
)
POSE_METRIC_NAMES = (
    "pose_mse_r12", "pose_mse_t12", "pose_mse_r21", "pose_mse_t21",
    "pose_mse_r_identity", "pose_mse_t_identity",
)
ALL_METRIC_NAMES = DEPTH_METRIC_NAMES + POSE_METRIC_NAMES


def _depth_suite(pred, target, valid, dims) -> Dict[str, torch.Tensor]:
    """The nine depth metrics with sums over `dims` (None = everything)."""
    def total(x):
        return x.sum() if dims is None else x.sum(dim=dims)

    valid = valid.bool()
    n = torch.clamp(total(valid), min=1)
    p = torch.where(valid, pred, 1.0)
    t = torch.where(valid, target, 1.0)

    thresh = torch.maximum(t / p, p / t)
    d1 = total(valid & (thresh < 1.25)) / n
    d2 = total(valid & (thresh < 1.25 ** 2)) / n
    d3 = total(valid & (thresh < 1.25 ** 3)) / n

    diff = torch.where(valid, p - t, 0.0)
    diff_log = torch.where(valid, torch.log(p) - torch.log(t), 0.0)

    abs_rel = total(torch.where(valid, diff.abs() / t, 0.0)) / n
    sq_rel = total(torch.where(valid, diff * diff / t, 0.0)) / n
    rmse = torch.sqrt(total(diff * diff) / n)
    rmse_log = torch.sqrt(total(diff_log * diff_log) / n)
    log10 = total(torch.where(
        valid, (torch.log10(p) - torch.log10(t)).abs(), 0.0)) / n
    mean_dl2 = total(diff_log * diff_log) / n
    mean_dl = total(diff_log) / n
    silog = torch.sqrt(torch.clamp(mean_dl2 - 0.5 * mean_dl * mean_dl,
                                   min=0.0))
    return {
        "d1": d1, "d2": d2, "d3": d3, "abs_rel": abs_rel, "sq_rel": sq_rel,
        "rmse": rmse, "rmse_log": rmse_log, "log10": log10, "silog": silog,
    }


def eval_depth_masked(pred: torch.Tensor, target: torch.Tensor,
                      valid: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Depth metric suite over the pixels where `valid` is True: equal to the
    suite applied to pred[valid], target[valid]. Returns a dict of scalars."""
    pred, target, valid = torch.broadcast_tensors(pred, target, valid)
    return _depth_suite(pred, target, valid, None)


def eval_depth_masked_per_sample(pred: torch.Tensor, target: torch.Tensor,
                                 valid: torch.Tensor
                                 ) -> Dict[str, torch.Tensor]:
    """Per-sample depth metric suite: reductions over the pixel axes only.
    Inputs (B, H, W); returns a dict of (B,) vectors whose mean over samples
    is the batch-size-1 validation protocol. Samples with no valid pixel
    return 0 in every metric (mask them out on the host)."""
    dims = tuple(range(1, pred.dim()))
    out = _depth_suite(pred, target, valid, dims)
    any_valid = valid.bool().sum(dim=dims) > 0
    return {k: torch.where(any_valid, v, 0.0) for k, v in out.items()}


def _pose_metrics(pred, target, mean) -> Dict[str, torch.Tensor]:
    B = pred["R12"].shape[0]

    def mse(a, b):
        d = a.reshape(B, -1) - b.reshape(B, -1)
        return mean(d * d)

    out = {
        "pose_mse_r12": mse(pred["R12"], target["R12"]),
        "pose_mse_t12": mse(pred["T12"], target["T12"]),
    }
    if pred.get("R21") is None:
        zero = torch.zeros_like(out["pose_mse_r12"])
        out.update({
            "pose_mse_r21": zero, "pose_mse_t21": zero,
            "pose_mse_r_identity": zero, "pose_mse_t_identity": zero,
        })
        return out
    out["pose_mse_r21"] = mse(pred["R21"], target["R21"])
    out["pose_mse_t21"] = mse(pred["T21"], target["T21"])
    R12 = pred["R12"].reshape(B, 3, 3)
    R21 = pred["R21"].reshape(B, 3, 3)
    T12 = pred["T12"].reshape(B, 3, 1)
    T21 = pred["T21"].reshape(B, 3, 1)
    eye = torch.eye(3, dtype=R12.dtype, device=R12.device).expand(B, 3, 3)
    dR = (R12 @ R21 - eye).reshape(B, -1)
    out["pose_mse_r_identity"] = mean(dR * dR)
    dT = (T12 + R12 @ T21).reshape(B, -1)
    out["pose_mse_t_identity"] = mean(dT * dT)
    return out


def eval_pose_per_sample(pred: Dict[str, torch.Tensor],
                         target: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """Per-sample pose MSEs + cycle-consistency checks ((B,) vectors); the
    batch mean of each equals eval_pose at batch size 1 averaged over
    samples."""
    return _pose_metrics(pred, target, lambda x: x.mean(dim=1))


def eval_pose(pred: Dict[str, torch.Tensor], target: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
    """Pose MSEs + cycle-consistency identity checks, as scalars.
    pred/target keys: R12 (B, 9 or B, 3, 3), T12 (B, 3), optionally R21/T21;
    when R21 is absent or None the r21/t21/identity entries are 0."""
    return _pose_metrics(pred, target, lambda x: x.mean())


def eval_mask(dataset: str, pred: torch.Tensor, gt: torch.Tensor, *,
              min_depth_eval: float, max_depth_eval: float,
              do_kb_crop: bool = True, kitti_crop: Optional[str] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Clamp pred (inf -> max_depth_eval, nan -> min_depth_eval) and build
    the dataset's valid mask. Returns (pred_clamped, gt, mask). For KITTI
    the caller passes already-KB-cropped gt/pred (`do_kb_crop` is the data
    pipeline's business) and `kitti_crop` applies the garg/eigen region."""
    del do_kb_crop
    pred = torch.where(torch.isinf(pred), max_depth_eval, pred)
    pred = torch.where(torch.isnan(pred), min_depth_eval, pred)
    valid = (gt > min_depth_eval) & (gt < max_depth_eval)

    H, W = gt.shape[-2], gt.shape[-1]
    rows = torch.arange(H, device=gt.device)[:, None]
    cols = torch.arange(W, device=gt.device)[None, :]

    if dataset == "kitti" and kitti_crop in ("garg_crop", "eigen_crop"):
        if kitti_crop == "garg_crop":
            r0, r1 = int(0.40810811 * H), int(0.99189189 * H)
        else:
            r0, r1 = int(0.3324324 * H), int(0.91351351 * H)
        c0, c1 = int(0.0359477 * W), int(0.96405229 * W)
        region = (rows >= r0) & (rows < r1) & (cols >= c0) & (cols < c1)
        valid = valid & region
    elif dataset == "nyudepthv2":
        region = (rows >= 45) & (rows < 471) & (cols >= 41) & (cols < 601)
        valid = valid & region
    # 'void' and others: min/max valid mask only
    return pred, gt, valid


def eval_depth_np(pred: np.ndarray, target: np.ndarray) -> Dict[str, float]:
    """The depth suite in numpy (float64) over flattened, already-valid
    arrays."""
    assert pred.shape == target.shape
    pred = pred.reshape(-1).astype(np.float64)
    target = target.reshape(-1).astype(np.float64)
    thresh = np.maximum(target / pred, pred / target)
    n = len(thresh)
    d1 = float((thresh < 1.25).sum()) / n
    d2 = float((thresh < 1.25 ** 2).sum()) / n
    d3 = float((thresh < 1.25 ** 3).sum()) / n
    diff = pred - target
    diff_log = np.log(pred) - np.log(target)
    abs_rel = float(np.mean(np.abs(diff) / target))
    sq_rel = float(np.mean(diff ** 2 / target))
    rmse = float(np.sqrt(np.mean(diff ** 2)))
    rmse_log = float(np.sqrt(np.mean(diff_log ** 2)))
    log10 = float(np.mean(np.abs(np.log10(pred) - np.log10(target))))
    silog = float(np.sqrt(np.mean(diff_log ** 2) - 0.5 * np.mean(diff_log) ** 2))
    return {"d1": d1, "d2": d2, "d3": d3, "abs_rel": abs_rel, "sq_rel": sq_rel,
            "rmse": rmse, "rmse_log": rmse_log, "log10": log10, "silog": silog}
