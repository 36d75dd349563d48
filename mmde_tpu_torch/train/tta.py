"""Test-time augmentation: horizontal-flip averaging and shift-window
evaluation for wide images.

Counterpart of mmde_tpu/train/tta.py:
  * flip TTA - run the model on the mirrored frames and average the
    un-mirrored depth with the plain pass's (`flip_average`, and the
    two-frame form the eval step applies: pose from the plain pass, since
    mirroring changes the true pose);
  * shift-window TTA - slide (H x crop) windows across the width with a
    fixed stride, run them through the model as one batch, and recompose
    the depth by coverage-weighted averaging; the two-frame form crops both
    frames in lockstep and averages the pose predictions over the windows
    (the rotations' chordal mean re-projected onto SO(3)).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from mmde_tpu_torch.geometry import normalize_rotation


def flip_average(forward: Callable[[torch.Tensor], torch.Tensor],
                 image: torch.Tensor) -> torch.Tensor:
    """forward: (B, H, W, 3) -> (B, H, W, 1) depth. Averages the plain and
    the mirrored pass."""
    d = forward(image)
    d_flip = forward(torch.flip(image, dims=(2,)))
    return 0.5 * (d + torch.flip(d_flip, dims=(2,)))


def flip_average_two_frame(forward, frame1: torch.Tensor,
                           frame2: torch.Tensor, **maps: torch.Tensor
                           ) -> Dict[str, torch.Tensor]:
    """forward(frame1, frame2, **maps) -> output dict. Depth maps are
    averaged with the un-mirrored prediction of the mirrored frames; pose
    outputs come from the plain pass. `maps` (sparse depth, (B, H, W[, 1]))
    go to each pass as they are and mirrored on the width with the
    frames."""
    out = dict(forward(frame1, frame2, **maps))
    fout = forward(torch.flip(frame1, dims=(2,)), torch.flip(frame2, dims=(2,)),
                   **{k: torch.flip(v, dims=(2,)) for k, v in maps.items()})
    for k in ("pred_d1", "pred_d2"):
        out[k] = 0.5 * (out[k] + torch.flip(fout[k], dims=(2,)))
    return out


def shift_window_positions(width: int, crop: int, stride: int) -> List[int]:
    """Left edges of the sliding crops, always covering the right border."""
    xs = list(range(0, max(width - crop, 0) + 1, stride))
    if xs[-1] != width - crop:
        xs.append(width - crop)
    return xs


def _recompose(d: torch.Tensor, xs: List[int], B: int, H: int, W: int,
               crop: int) -> torch.Tensor:
    """(S*B, H, crop, C) window predictions, window-major -> (B, H, W, C),
    each column divided by the number of windows covering it."""
    d = d.reshape(len(xs), B, H, crop, -1)
    acc = torch.zeros((B, H, W, d.shape[-1]), dtype=d.dtype, device=d.device)
    count = torch.zeros((1, 1, W, 1), dtype=d.dtype, device=d.device)
    for i, x in enumerate(xs):
        acc[:, :, x:x + crop, :] += d[i]
        count[:, :, x:x + crop, :] += 1.0
    return acc / count


def shift_window_eval(forward: Callable[[torch.Tensor], torch.Tensor],
                      image: torch.Tensor, crop: int,
                      stride: Optional[int] = None) -> torch.Tensor:
    """Slide (H x crop) windows across the width and average overlapping
    predictions by coverage count. image: (B, H, W, 3) with H <= crop <= W;
    forward: (S*B, H, crop, 3) -> (S*B, H, crop, C). Returns (B, H, W, C)."""
    B, H, W, _ = image.shape
    stride = stride or crop // 2
    xs = shift_window_positions(W, crop, stride)
    crops = torch.cat([image[:, :, x:x + crop, :] for x in xs], dim=0)
    return _recompose(forward(crops), xs, B, H, W, crop)


def shift_window_eval_two_frame(forward, frame1: torch.Tensor,
                                frame2: torch.Tensor, crop: int,
                                stride: Optional[int] = None
                                ) -> Dict[str, Optional[torch.Tensor]]:
    """Shift-window TTA for the two-frame family. forward: (S*B, H, crop,
    3) x 2 -> dict with pred_d1 / pred_d2 (S*B, H, crop, 1) and the pose
    outputs (S*B, 9) / (S*B, 3) (r21 / t21 may be None, decoder_v1). Both
    frames are cropped in lockstep; the depth maps are recomposed by
    coverage-weighted averaging, the pose predictions averaged over the
    windows, the rotations re-projected onto SO(3)."""
    B, H, W, _ = frame1.shape
    stride = stride or crop // 2
    xs = shift_window_positions(W, crop, stride)
    S = len(xs)
    c1 = torch.cat([frame1[:, :, x:x + crop, :] for x in xs], dim=0)
    c2 = torch.cat([frame2[:, :, x:x + crop, :] for x in xs], dim=0)
    out = forward(c1, c2)
    res = dict(out)
    for k in ("pred_d1", "pred_d2"):
        if out.get(k) is not None:
            res[k] = _recompose(out[k], xs, B, H, W, crop)
    for k in ("pred_r12", "pred_r21"):
        if out.get(k) is not None:
            res[k] = normalize_rotation(out[k].reshape(S, B, 9).mean(dim=0))
    for k in ("pred_t12", "pred_t21"):
        if out.get(k) is not None:
            res[k] = out[k].reshape(S, B, -1).mean(dim=0)
    return res
