"""Visualisation artifacts: depth colour maps, comparison panels, pose txt
dumps, 16-bit depth PNGs.

Counterpart of mmde_tpu/utils/viz.py (the reference's utils/viz_utils.py
and the eval PNG export at test.py:125-137) without cv2: the colour maps
are cv2's COLORMAP_RAINBOW and COLORMAP_WINTER as 256-entry tables built
in numpy from cv2's definitions (`colormap_table`), and the PNGs go through
data.codec. Colour images are BGR, as the JAX functions return them; the
panels are written as RGB PNGs, so they decode to the JAX writer's pixels.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from mmde_tpu_torch.data.codec import write_png


def _linspace32(n: int) -> np.ndarray:
    """cv2's colormap linspace(0, 1, n): x0 + i * step in float32."""
    step = np.float32(1.0) / np.float32(n - 1)
    return np.arange(n, dtype=np.float32) * step


def _interp1(x: np.ndarray, y: np.ndarray, xi: np.ndarray) -> np.ndarray:
    """cv2's colormap interp1 in float32: y[lo] + (xi - x[lo]) * (y[hi] -
    y[lo]) / (x[hi] - x[lo]), lo the last key below xi."""
    lo = np.clip(np.searchsorted(x, xi, side="left") - 1, 0, len(x) - 2)
    hi = lo + 1
    return y[lo] + ((xi - x[lo]) * (y[hi] - y[lo])) / (x[hi] - x[lo])


def _rainbow_keys():
    """GNU Octave's rainbow at 64 keys (cv2's Rainbow tables)."""
    x = np.linspace(0, 1, 64)
    a, b, c = x < 2 / 5, (x >= 2 / 5) & (x < 3 / 5), (x >= 3 / 5) & (x < 4 / 5)
    r = a + b * (-5 * x + 3) + (x >= 4 / 5) * (10 / 3 * x - 8 / 3)
    g = a * (5 / 2 * x) + b + c * (-5 * x + 4)
    bl = c * (5 * x - 3) + (x >= 4 / 5)
    return r, g, bl


def _winter_keys():
    """GNU Octave's winter at 11 keys (cv2's Winter tables)."""
    return (np.zeros(11), np.linspace(0, 1, 11),
            np.array([1.0, 0.95, 0.9, 0.85, 0.8, 0.75, 0.7,
                      0.6499999999999999, 0.6, 0.55, 0.5]))


_KEYS = {"rainbow": _rainbow_keys, "winter": _winter_keys}


def colormap_table(name: str) -> np.ndarray:
    """(256, 3) uint8 BGR table of cv2's COLORMAP_<NAME> (rainbow, winter):
    the keys as float32 at linspace(0, 1, n), interpolated to 256 entries,
    times 255 rounded half to even and saturated, as cv2's
    ColorMap::linear_colormap and convertTo do."""
    r, g, b = (np.asarray(k, np.float64).astype(np.float32)
               for k in _KEYS[name]())
    x, xi = _linspace32(len(r)), _linspace32(256)
    planes = [_interp1(x, c, xi) for c in (b, g, r)]
    v = np.stack(planes, axis=-1) * np.float32(255)
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)


def colorize_depth(depth: np.ndarray, max_val: Optional[float] = None
                   ) -> np.ndarray:
    """Depth (H, W) -> (H, W, 3) uint8 BGR through the rainbow colour map,
    depth / max_val (default: the depth's maximum) spread over 0..255."""
    if max_val is None:
        max_val = max(float(depth.max()), 1e-6)
    d8 = np.clip(depth / max_val * 255.0, 0, 255).astype(np.uint8)
    return colormap_table("rainbow")[d8]


def error_map(gt: np.ndarray, pred: np.ndarray,
              max_val: Optional[float] = None) -> np.ndarray:
    """|gt - pred| on the 0..255 scale of max_val (default: the larger
    maximum), through the winter colour map: (H, W, 3) uint8 BGR."""
    if max_val is None:
        max_val = max(float(gt.max()), float(pred.max()), 1e-6)
    g8 = np.clip(gt / max_val * 255.0, 0, 255).astype(np.uint8)
    p8 = np.clip(pred / max_val * 255.0, 0, 255).astype(np.uint8)
    err = np.abs(g8.astype(np.int16) - p8.astype(np.int16)).astype(np.uint8)
    return colormap_table("winter")[err]


def save_comparison_panel(save_dir: str, filename: str,
                          image1: np.ndarray, image2: np.ndarray,
                          gt1: np.ndarray, gt2: np.ndarray,
                          pred1: np.ndarray, pred2: np.ndarray) -> str:
    """Stacked panel, two frames wide: the frames (floats in 0..1), the
    ground-truth depths, the predictions and the error maps, rows apart by
    4-pixel white bars (Visualize_CV, viz_utils.py:25-66); depths coloured
    on one scale, the predictions' maximum. Written as RGB PNG; returns its
    path."""
    os.makedirs(save_dir, exist_ok=True)
    vmax = max(float(pred1.max()), float(pred2.max()), 1e-6)

    def to_bgr(img):
        return np.clip(img * 255.0, 0, 255).astype(np.uint8)[..., ::-1]

    rows = [
        np.hstack([to_bgr(image1), to_bgr(image2)]),
        np.hstack([colorize_depth(gt1, vmax), colorize_depth(gt2, vmax)]),
        np.hstack([colorize_depth(pred1, vmax), colorize_depth(pred2, vmax)]),
        np.hstack([error_map(gt1, pred1, vmax), error_map(gt2, pred2, vmax)]),
    ]
    sep = np.full((4, rows[0].shape[1], 3), 255, np.uint8)
    panel = rows[0]
    for r in rows[1:]:
        panel = np.vstack([panel, sep, r])
    out_path = os.path.join(save_dir, filename if filename.endswith(".png")
                            else filename + ".png")
    write_png(out_path, np.ascontiguousarray(panel[..., ::-1]))
    return out_path


def save_pose_txt(save_dir: str, filename: str,
                  R_gt: np.ndarray, R_pred: np.ndarray,
                  T_gt: np.ndarray, T_pred: np.ndarray) -> str:
    """Ground-truth and predicted 3x4 [R|T] to a txt file
    (viz_utils.py:68-84); returns its path."""
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, filename if filename.endswith(".txt")
                        else filename + ".txt")
    gt = np.hstack([np.asarray(R_gt).reshape(3, 3),
                    np.asarray(T_gt).reshape(3, 1)])
    pr = np.hstack([np.asarray(R_pred).reshape(3, 3),
                    np.asarray(T_pred).reshape(3, 1)])
    with open(path, "w") as f:
        f.write("# ground truth [R|T]\n")
        np.savetxt(f, gt, fmt="%.8f")
        f.write("# prediction [R|T]\n")
        np.savetxt(f, pr, fmt="%.8f")
    return path


def save_depth_png16(path: str, depth_m: np.ndarray, dataset: str) -> None:
    """Write a depth map in metres to `path` as a 16-bit PNG: x256 for
    KITTI, x1000 (millimetres) otherwise, truncated (test.py:125-137)."""
    scale = 256.0 if dataset == "kitti" else 1000.0
    write_png(path, (np.asarray(depth_m) * scale).astype(np.uint16))
