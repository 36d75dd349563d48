"""Forward entry of the serving path.

Counterpart of the inference part of mmde_tpu/train/step.py: `_image`
(device-side normalisation of uint8-shipped frames) and `make_forward`. The
train step, the eval steps and their losses/metrics are not ported yet.
"""
from __future__ import annotations

import torch


def _image(x: torch.Tensor) -> torch.Tensor:
    """uint8 frames -> float32 / 255 on the tensor's device (4x fewer
    host-to-device bytes than shipping floats); float frames pass through."""
    if x.dtype == torch.uint8:
        return x.float() / 255.0
    return x


def make_forward(model):
    """Plain inference forward (for TTA / serving): eval mode, no gradient
    recorded — which is also what the CUDA attention kernel requires, its
    backward not being ported yet.

    forward(frame1, frame2) takes NHWC tensors on the model's device, uint8
    or float, and returns the model's output dict."""
    model.eval()

    def forward(frame1: torch.Tensor, frame2: torch.Tensor):
        with torch.inference_mode():
            return model(_image(frame1), _image(frame2))

    return forward
