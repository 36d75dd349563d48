"""Synthetic in-memory two-frame dataset.

Counterpart of mmde_tpu/data/synthetic.py::SyntheticTwoFrameDataset:
deterministic random RGB pairs, smooth positive depth maps with a tenth of
the pixels invalid, and consistent relative poses (T21 = inv(T12)), in the
batch layout the train step consumes; sample i is drawn from
`np.random.default_rng(seed * 100003 + i)` in the same order, so both
packages give the same arrays. The `depth_cue` variant's bilinear upsample
is `resize_bilinear` here (numpy, cv2's INTER_LINEAR convention) where the
JAX package calls cv2, which the card machine does not have.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from mmde_tpu_torch.geometry import exp_so3


def _linear_taps(n_out: int, n_in: int):
    """Source indices and weights of cv2's INTER_LINEAR along one axis:
    half-pixel centres, f = (x + 0.5) * n_in / n_out - 0.5 in float64, the
    weight its fractional part in float32, clamped to the border (weight 0
    past either edge)."""
    f = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    i0 = np.floor(f).astype(np.int64)
    w = (f - i0).astype(np.float32)
    w[i0 < 0] = 0.0
    i0[i0 < 0] = 0
    edge = i0 >= n_in - 1
    w[edge] = 0.0
    i0[edge] = n_in - 1
    return i0, np.minimum(i0 + 1, n_in - 1), w


def resize_bilinear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """`cv2.resize(img, (width, height), interpolation=cv2.INTER_LINEAR)`
    of a 2-D float32 array: the horizontal pass, then the vertical one, in
    float32."""
    x0, x1, wx = _linear_taps(width, img.shape[1])
    y0, y1, wy = _linear_taps(height, img.shape[0])
    rows = img[:, x0] * (1.0 - wx) + img[:, x1] * wx
    out = rows[y0] * (1.0 - wy)[:, None] + rows[y1] * wy[:, None]
    return out.astype(np.float32)


class SyntheticTwoFrameDataset:
    """`num_samples` two-frame samples of `height` x `width`.

    uint8_images ships RGB as uint8 (normalised on the device,
    train/step._image); sparse_depth adds VIO-style sparse depth maps (~5 %
    of the pixels); depth_cue embeds depth / max in the red channel (plus
    noise) and upsamples the depth bilinearly, so that depth is learnable
    from RGB (the convergence gate's data); the default keeps depth
    independent of the frames (memorisable, not learnable)."""

    def __init__(self, num_samples: int = 64, height: int = 96,
                 width: int = 128, max_depth: float = 10.0, seed: int = 0,
                 imu_max_len: int = 32, sparse_depth: bool = False,
                 uint8_images: bool = False, depth_cue: bool = False):
        self.num_samples = num_samples
        self.height = height
        self.width = width
        self.max_depth = max_depth
        self.seed = seed
        self.imu_max_len = imu_max_len
        self.sparse_depth = sparse_depth
        self.uint8_images = uint8_images
        self.depth_cue = depth_cue

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed * 100003 + idx)
        H, W = self.height, self.width

        def smooth_depth():
            base = rng.uniform(0.5, self.max_depth * 0.9,
                               size=(H // 8 + 1, W // 8 + 1)).astype(np.float32)
            if self.depth_cue:
                # bilinear: the nearest-neighbour target's jumps at every
                # 8x8 block edge are more than a conv decoder can fit
                d = resize_bilinear(base, W, H)
            else:
                d = np.kron(base, np.ones((8, 8), np.float32))[:H, :W]
            mask = rng.random((H, W)) < 0.1   # 10% invalid pixels
            d[mask] = 0.0
            return d

        img1 = rng.random((H, W, 3), dtype=np.float32)
        img2 = np.clip(img1 + rng.normal(0, 0.05, img1.shape), 0, 1).astype(np.float32)
        depth1 = smooth_depth()
        depth2 = smooth_depth()
        if self.depth_cue:
            def cue(img, depth):
                img = img.copy()
                r = (depth / (self.max_depth * 1.1)).astype(np.float32)
                noise = rng.normal(0, 0.01, r.shape).astype(np.float32)
                # invalid (0) pixels keep the random channel
                img[..., 0] = np.where(depth > 0,
                                       np.clip(r + noise, 0, 1), img[..., 0])
                return img
            img1 = cue(img1, depth1)
            img2 = cue(img2, depth2)
        if self.uint8_images:
            img1 = np.round(img1 * 255.0).astype(np.uint8)
            img2 = np.round(img2 * 255.0).astype(np.uint8)

        w = rng.standard_normal(3) * 0.1
        t = rng.standard_normal(3) * 0.05
        R12 = exp_so3(w).astype(np.float32)
        T12 = t.astype(np.float32)
        R21 = R12.T.copy()
        T21 = (-R12.T @ t).astype(np.float32)

        n_imu = int(rng.integers(4, self.imu_max_len))
        imu = np.zeros((self.imu_max_len, 7), np.float32)
        imu[:n_imu] = rng.standard_normal((n_imu, 7)).astype(np.float32)
        imu_ts = np.zeros((self.imu_max_len,), np.float32)
        imu_ts[:n_imu] = np.sort(rng.random(n_imu)).astype(np.float32)

        out = {
            "image1": img1, "image2": img2,
            "depth1": depth1, "depth2": depth2,
            "R12": R12, "T12": T12, "R21": R21, "T21": T21,
            "imu_data": imu, "imu_len": np.int32(n_imu),
            "imu_timestamp": imu_ts,
        }
        if self.sparse_depth:
            keep1 = rng.random((H, W)) < 0.05
            keep2 = rng.random((H, W)) < 0.05
            out["sparse_depth1"] = np.where(keep1, depth1, 0.0).astype(np.float32)
            out["sparse_depth2"] = np.where(keep2, depth2, 0.0).astype(np.float32)
        return out

    def batches(self, batch_size: int, steps: int) -> Iterator[Dict[str, np.ndarray]]:
        """Yield `steps` stacked batches (cycling through samples)."""
        i = 0
        for _ in range(steps):
            items = [self[(i + k) % self.num_samples] for k in range(batch_size)]
            i += batch_size
            yield {k: np.stack([it[k] for it in items]) for k in items[0]}
