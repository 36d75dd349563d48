"""Geometry helpers used inside the model.

Counterpart of the in-graph part of mmde_tpu/geometry.py that the serving
path needs: `normalize_rotation`. The SO(3)/SE(3) utilities used by losses,
metrics and data come with the training path.
"""
from __future__ import annotations

import torch


def normalize_rotation(rot9: torch.Tensor) -> torch.Tensor:
    """Project a batch of 9-dim rotation vectors onto (near-)orthonormal
    matrices via SVD: R_hat = U @ Vh, flattened back to 9-dim. No det-sign
    correction (the reference does not force det = +1). Computed in
    float32, returned in the input's type."""
    shape = rot9.shape
    R = rot9.float().reshape(shape[:-1] + (3, 3))
    U, _, Vh = torch.linalg.svd(R, full_matrices=False)
    return (U @ Vh).reshape(shape).to(rot9.dtype)
