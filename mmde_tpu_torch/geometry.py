"""SO(3)/SE(3) geometry: host (numpy) and on-device (torch) variants.

Counterpart of mmde_tpu/geometry.py. The numpy half (skew, exp_so3, log_so3,
se3, inv_se3, relative_pose, relative_pose_parts) builds relative poses from
absolute pose files on the host; the torch half is batched and
differentiable: skew_torch, exp_so3_torch, log_so3_torch (the JAX package's
`*_jax` functions), normalize_rotation and rotation_geodesic_angle.
"""
from __future__ import annotations

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Host side (numpy)
# ---------------------------------------------------------------------------

_EPS = 1e-8


def skew(x: np.ndarray) -> np.ndarray:
    """3-vector -> 3x3 skew-symmetric matrix."""
    x = np.asarray(x).reshape(3)
    return np.array([
        [0.0, -x[2], x[1]],
        [x[2], 0.0, -x[0]],
        [-x[1], x[0], 0.0],
    ])


def exp_so3(w: np.ndarray) -> np.ndarray:
    """Rodrigues' formula: axis-angle 3-vector -> rotation matrix, with the
    small-angle branch I + skew(w) for |w| < 1e-8."""
    w = np.asarray(w, dtype=np.float64).reshape(3)
    angle = np.linalg.norm(w)
    if abs(angle) < _EPS:
        return np.identity(3) + skew(w)
    axis = w / angle
    K = skew(axis)
    s, c = np.sin(angle), np.cos(angle)
    return c * np.identity(3) + s * K + (1.0 - c) * np.outer(axis, axis)


def log_so3(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> axis-angle 3-vector."""
    R = np.asarray(R, dtype=np.float64)
    tr = np.trace(R)
    angle = np.arccos(max(-1.0, min(1.0, 0.5 * (tr - 1.0))))
    if abs(angle) < _EPS:
        W = 0.5 * (R - R.T)
        return np.array([W[2, 1], W[0, 2], W[1, 0]])
    s = np.sin(angle)
    W = (angle / (2.0 * s)) * (R - R.T)
    return np.array([W[2, 1], W[0, 2], W[1, 0]])


def se3(t: np.ndarray, R: np.ndarray) -> np.ndarray:
    """Assemble a 4x4 homogeneous transform from translation + rotation."""
    T = np.zeros((4, 4))
    T[:3, :3] = R
    T[:3, 3] = np.asarray(t).reshape(3)
    T[3, 3] = 1.0
    return T


def inv_se3(T: np.ndarray) -> np.ndarray:
    """Inverse of a 4x4 SE(3) transform."""
    R = T[:3, :3]
    t = T[:3, 3]
    return se3(-R.T @ t, R.T)


def relative_pose(T01: np.ndarray, T02: np.ndarray) -> np.ndarray:
    """Relative SE(3) taking frame-1 coordinates to frame-2 coordinates given
    two world poses (tail to tail): T12 = [R01^T R02 | R01^T (t02 - t01)]."""
    R01, t01 = T01[:3, :3], T01[:3, 3]
    R02, t02 = T02[:3, :3], T02[:3, 3]
    R10 = R01.T
    return se3(R10 @ (t02 - t01), R10 @ R02)


def relative_pose_parts(T01: np.ndarray, T02: np.ndarray):
    """Relative pose decomposed the way the VOID loader returns it:
    (RT, T (3,1), R (3,3), w (3,1), axis_angle (4,1) = [w/|w| ; |w|])."""
    RT = relative_pose(T01, T02)
    T = RT[:3, 3].reshape(3, 1)
    R = RT[:3, :3]
    w = log_so3(R).reshape(3, 1)
    n = np.linalg.norm(w)
    axis_angle = np.concatenate([w / n if n > 0 else w, np.array([[n]])],
                                axis=0)
    return RT, T, R, w, axis_angle


# ---------------------------------------------------------------------------
# On device (torch): batched, differentiable
# ---------------------------------------------------------------------------


def skew_torch(x: torch.Tensor) -> torch.Tensor:
    """Batched skew: (..., 3) -> (..., 3, 3)."""
    x0, x1, x2 = x[..., 0], x[..., 1], x[..., 2]
    z = torch.zeros_like(x0)
    return torch.stack([
        torch.stack([z, -x2, x1], dim=-1),
        torch.stack([x2, z, -x0], dim=-1),
        torch.stack([-x1, x0, z], dim=-1),
    ], dim=-2)


def exp_so3_torch(w: torch.Tensor) -> torch.Tensor:
    """Batched Rodrigues: (..., 3) -> (..., 3, 3). sin(a)/a and
    (1 - cos(a))/a^2 with Taylor fallbacks below |w|^2 = 1e-12, so it is
    differentiable at w = 0 (both branches of a `where` are differentiated:
    the trigonometric one sees a strictly positive angle there)."""
    angle2 = (w * w).sum(-1)
    small = angle2 < 1e-12
    angle2_safe = torch.where(small, torch.ones_like(angle2), angle2)
    angle = torch.sqrt(angle2_safe)
    A = torch.where(small, 1.0 - angle2 / 6.0, torch.sin(angle) / angle)
    B = torch.where(small, 0.5 - angle2 / 24.0,
                    (1.0 - torch.cos(angle)) / angle2_safe)
    K = skew_torch(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + A[..., None, None] * K + B[..., None, None] * (K @ K)


def log_so3_torch(R: torch.Tensor) -> torch.Tensor:
    """Batched SO(3) log: (..., 3, 3) -> (..., 3)."""
    tr = torch.diagonal(R, dim1=-2, dim2=-1).sum(-1)
    cos_a = torch.clamp(0.5 * (tr - 1.0), -1.0, 1.0)
    angle = torch.arccos(cos_a)
    W = 0.5 * (R - R.transpose(-1, -2))
    vee = torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)
    s = torch.sin(angle)
    small = angle.abs() < 1e-8
    scale = torch.where(small, torch.ones_like(angle),
                        angle / torch.clamp(s, min=1e-24))
    return scale[..., None] * vee


def normalize_rotation(rot9: torch.Tensor) -> torch.Tensor:
    """Project a batch of 9-dim rotation vectors onto (near-)orthonormal
    matrices via SVD: R_hat = U @ Vh, flattened back to 9-dim. No det-sign
    correction (the reference does not force det = +1). Computed in
    float32, returned in the input's type."""
    shape = rot9.shape
    R = rot9.float().reshape(shape[:-1] + (3, 3))
    U, _, Vh = torch.linalg.svd(R, full_matrices=False)
    return (U @ Vh).reshape(shape).to(rot9.dtype)


def rotation_geodesic_angle(R1: torch.Tensor, R2: torch.Tensor
                            ) -> torch.Tensor:
    """Angle (radians) between two batches of rotation matrices."""
    M = R1 @ R2.transpose(-1, -2)
    tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)
    return torch.arccos(torch.clamp(0.5 * (tr - 1.0), -1.0, 1.0))
