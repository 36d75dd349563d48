"""Multi-dataset mixing into the unified two-frame batch schema.

Counterpart of mmde_tpu/data/mixed.py without cv2 (the resizes through
data.imgproc), with the same schedule for the same seed.

BASELINE config #5: multi-dataset (NYU + KITTI + VOID) bf16 data-parallel
training at large batch. Each source dataset is adapted to one schema so a
single jitted train step handles mixed batches with static shapes:

    image1/image2 (H, W, 3) float32, depth1/depth2 (H, W) float32,
    R12/R21 (3, 3), T12/T21 (3,), pose_valid () float32,
    dataset_id () int32.

Adaptation rules:
  * two-frame with pose (VOID v3, synthetic): passthrough, pose_valid=1;
  * two-frame without pose (NYU pairs): identity pose, pose_valid=0
    (the pose loss masks these samples — losses.weighted_mse_loss);
  * single-frame (NYU v1, KITTI): frame2 = frame1 and the identity IS the
    true relative pose, pose_valid=1.

All sources are resized/cropped to a common (H, W) so batches stack.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mmde_tpu_torch.data.imgproc import resize_linear, resize_nearest

_EYE = np.eye(3, dtype=np.float32)
_ZERO3 = np.zeros(3, np.float32)


def _fit(image: np.ndarray, depth: np.ndarray, H: int, W: int):
    """Center-crop (or resize up if too small) to exactly (H, W)."""
    h, w = depth.shape[:2]
    if h < H or w < W:
        image = resize_linear(image, max(w, W), max(h, H))
        depth = resize_nearest(depth, max(w, W), max(h, H))
        h, w = depth.shape[:2]
    top, left = (h - H) // 2, (w - W) // 2
    return (image[top:top + H, left:left + W],
            depth[top:top + H, left:left + W])


class UnifiedTwoFrame:
    """Adapter from any supported source dataset to the unified schema."""

    def __init__(self, dataset, kind: str, crop: Tuple[int, int],
                 dataset_id: int = 0):
        """kind: "two_frame_pose" | "two_frame" | "single_frame"."""
        self.ds = dataset
        self.kind = kind
        self.crop = crop
        self.dataset_id = dataset_id

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        H, W = self.crop
        s = self.ds[idx]
        if self.kind == "two_frame_pose":
            i1, d1 = _fit(s["image1"], s["depth1"], H, W)
            i2, d2 = _fit(s["image2"], s["depth2"], H, W)
            out = {"image1": i1, "depth1": d1, "image2": i2, "depth2": d2,
                   "R12": s["R12"], "T12": s["T12"],
                   "R21": s["R21"], "T21": s["T21"],
                   "pose_valid": np.float32(1.0)}
        elif self.kind == "two_frame":
            i1, d1 = _fit(s["image1"], s["depth1"], H, W)
            i2, d2 = _fit(s["image2"], s["depth2"], H, W)
            out = {"image1": i1, "depth1": d1, "image2": i2, "depth2": d2,
                   "R12": _EYE, "T12": _ZERO3, "R21": _EYE, "T21": _ZERO3,
                   "pose_valid": np.float32(0.0)}
        else:  # single_frame: pair with itself; identity is the true pose
            i1, d1 = _fit(s["image"], s["depth"], H, W)
            out = {"image1": i1, "depth1": d1,
                   "image2": i1.copy(), "depth2": d1.copy(),
                   "R12": _EYE, "T12": _ZERO3, "R21": _EYE, "T21": _ZERO3,
                   "pose_valid": np.float32(1.0)}
        out["dataset_id"] = np.int32(self.dataset_id)
        return out


class MixedDataset:
    """Weighted mixture over unified datasets with a deterministic schedule.

    Sampling: each index maps to (source, source_index) through a
    seed-derived permutation so epochs cover sources proportionally to their
    weights without replacement bias.
    """

    def __init__(self, sources: Sequence[UnifiedTwoFrame],
                 weights: Optional[Sequence[float]] = None,
                 epoch_size: Optional[int] = None, seed: int = 0):
        assert sources, "need at least one source"
        self.sources = list(sources)
        w = np.asarray(weights if weights is not None
                       else [len(s) for s in sources], np.float64)
        self.weights = w / w.sum()
        self.epoch_size = epoch_size or sum(len(s) for s in sources)
        rng = np.random.default_rng(seed)
        counts = np.floor(self.weights * self.epoch_size).astype(int)
        counts[0] += self.epoch_size - counts.sum()
        plan = []
        for src_i, c in enumerate(counts):
            n = len(self.sources[src_i])
            idxs = rng.permutation(n)
            reps = -(-c // n)
            idxs = np.tile(idxs, reps)[:c]
            plan.extend((src_i, int(j)) for j in idxs)
        rng.shuffle(plan)
        self.plan: List[Tuple[int, int]] = plan

    def __len__(self):
        return self.epoch_size

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        src_i, j = self.plan[idx % len(self.plan)]
        return self.sources[src_i][j]
