"""Test-time augmentation: horizontal-flip averaging.

Counterpart of `flip_average` in mmde_tpu/train/tta.py, plus the two-frame
form the JAX package's eval step applies (depth averaged over the plain and
the mirrored pass, pose taken from the plain pass: mirroring changes the
true pose). Shift-window evaluation is not ported yet.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch


def flip_average(forward: Callable[[torch.Tensor], torch.Tensor],
                 image: torch.Tensor) -> torch.Tensor:
    """forward: (B, H, W, 3) -> (B, H, W, 1) depth. Averages the plain and
    the mirrored pass."""
    d = forward(image)
    d_flip = forward(torch.flip(image, dims=(2,)))
    return 0.5 * (d + torch.flip(d_flip, dims=(2,)))


def flip_average_two_frame(forward, frame1: torch.Tensor,
                           frame2: torch.Tensor) -> Dict[str, torch.Tensor]:
    """forward(frame1, frame2) -> output dict. Depth maps are averaged with
    the un-mirrored prediction of the mirrored frames; pose outputs come from
    the plain pass."""
    out = dict(forward(frame1, frame2))
    fout = forward(torch.flip(frame1, dims=(2,)), torch.flip(frame2, dims=(2,)))
    for k in ("pred_d1", "pred_d2"):
        out[k] = 0.5 * (out[k] + torch.flip(fout[k], dims=(2,)))
    return out
