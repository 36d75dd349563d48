"""Training losses as masked, static-shape reductions.

Counterpart of mmde_tpu/losses.py: the scale-invariant log loss over the
`target > 0` pixels (lambda 0.5) and the plain / sample-weighted MSE of the
pose heads. Valid pixels are selected with `torch.where` sums and counts,
never boolean indexing: shapes stay static and no step waits on the host
for a pixel count.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def silog_loss(pred: torch.Tensor, target: torch.Tensor, lambd: float = 0.5,
               eps: float = 0.0) -> torch.Tensor:
    """Scale-invariant log loss over valid (target > 0) pixels:
    sqrt(mean(d^2) - lambd * mean(d)^2), d = log(target) - log(pred).
    pred/target broadcastable, any rank; returns a scalar, finite (0) when
    no pixel is valid. `eps` > 0 clamps pred away from zero."""
    valid = target > 0
    n = torch.clamp(valid.sum(), min=1)
    safe_t = torch.where(valid, target, 1.0)
    safe_p = torch.where(valid, torch.clamp(pred, min=eps) if eps else pred,
                         1.0)
    d = torch.where(valid, torch.log(safe_t) - torch.log(safe_p), 0.0)
    mean_d2 = (d * d).sum() / n
    mean_d = d.sum() / n
    return torch.sqrt(torch.clamp(mean_d2 - lambd * mean_d * mean_d, min=0.0))


def weighted_mse_loss(pred: torch.Tensor, target: torch.Tensor,
                      sample_weight: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """MSE between pred (B, K) and target reshaped to (B, K), mean over all
    elements. `sample_weight` (B,) masks samples without pose supervision:
    the mean is then over the weighted samples only."""
    B = pred.shape[0]
    diff = pred.reshape(B, -1) - target.reshape(B, -1)
    if sample_weight is None:
        return (diff * diff).mean()
    w = sample_weight.reshape(B, 1).to(diff.dtype)
    denom = torch.clamp(w.sum() * diff.shape[1], min=1.0)
    return (w * diff * diff).sum() / denom


def pose_losses(preds: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
                decoder: str = "decoder_v2"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rotation loss, translation loss). decoder_v1: the forward direction
    only (loss_T = MSE(t12), the intended semantics of the reference);
    decoder_v2: the mean of both directions."""
    w = batch.get("pose_valid")
    loss_r12 = weighted_mse_loss(preds["pred_r12"], batch["R12"], w)
    loss_t12 = weighted_mse_loss(preds["pred_t12"], batch["T12"], w)
    if decoder == "decoder_v1":
        return loss_r12, loss_t12
    loss_r21 = weighted_mse_loss(preds["pred_r21"], batch["R21"], w)
    loss_t21 = weighted_mse_loss(preds["pred_t21"], batch["T21"], w)
    return (loss_r12 + loss_r21) / 2.0, (loss_t12 + loss_t21) / 2.0


def _depth_pred(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return pred.squeeze(-1) if pred.dim() == target.dim() + 1 else pred


def total_loss(preds: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
               *, decoder: str = "decoder_v2", lambda_rot: float = 100.0,
               lambda_trans: float = 100.0, silog_lambda: float = 0.5):
    """(silog(d1) + silog(d2)) / 2 + lambda_rot * loss_R + lambda_trans *
    loss_T. Returns (total, aux dict of the four components)."""
    loss_d1 = silog_loss(_depth_pred(preds["pred_d1"], batch["depth1"]),
                         batch["depth1"], silog_lambda)
    loss_d2 = silog_loss(_depth_pred(preds["pred_d2"], batch["depth2"]),
                         batch["depth2"], silog_lambda)
    loss_depth = (loss_d1 + loss_d2) / 2.0
    loss_rot, loss_trans = pose_losses(preds, batch, decoder)
    total = loss_depth + lambda_rot * loss_rot + lambda_trans * loss_trans
    aux = {
        "loss_total": total,
        "loss_depth": loss_depth,
        "loss_rotation": loss_rot,
        "loss_translation": loss_trans,
    }
    return total, aux
