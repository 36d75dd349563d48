"""Host-side image/depth augmentation (numpy, no cv2, no albumentations).

Counterpart of mmde_tpu/data/augment.py: the same functions draw the same
numbers from the generator in the same order, so both packages' streams
stay in step. `hsv_jitter` always runs here, with imgproc's bitwise copies
of cv2's 8-bit HSV conversions: the JAX package's behaviour where cv2 is
installed (without cv2 it skips the jitter). Implements the reference's
augmentation policies natively:
  * v1 policy (dataset/base_dataset.py:29-58): horizontal flip, random crop,
    random brightness/contrast, random gamma, hue/saturation/value jitter,
    and the depth-strip paste trick (every 4th sample copies a random
    vertical band of the depth map into all 3 RGB channels);
  * v2 policy (dataset/base_dataset_v2.py:10-17): center crop + the same
    photometric jitter, no flip/random crop.

All functions take/return HWC uint8 or float32 RGB images and HW float32
depth maps and draw from an explicit numpy Generator — per-worker
deterministic streams replace the reference's global `random` state.
Parameter ranges mirror albumentations' defaults (brightness/contrast
±0.2 p=0.5, gamma 80..120 p=0.5, HSV 20/30/20 p=0.5).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from mmde_tpu_torch.data.imgproc import hsv_jitter_u8


def hflip(image: np.ndarray, depth: Optional[np.ndarray] = None):
    image = np.ascontiguousarray(image[:, ::-1])
    if depth is None:
        return image
    return image, np.ascontiguousarray(depth[:, ::-1])


def random_crop(image, depth, crop_h, crop_w, rng: np.random.Generator):
    H, W = image.shape[:2]
    top = int(rng.integers(0, max(H - crop_h, 0) + 1))
    left = int(rng.integers(0, max(W - crop_w, 0) + 1))
    return (image[top:top + crop_h, left:left + crop_w],
            depth[top:top + crop_h, left:left + crop_w])


def center_crop(image, depth, crop_h, crop_w):
    H, W = image.shape[:2]
    top = max((H - crop_h) // 2, 0)
    left = max((W - crop_w) // 2, 0)
    return (image[top:top + crop_h, left:left + crop_w],
            depth[top:top + crop_h, left:left + crop_w])


def random_brightness_contrast(image, rng, limit: float = 0.2, p: float = 0.5):
    """image: uint8 or float in [0,1]."""
    if rng.random() >= p:
        return image
    alpha = 1.0 + rng.uniform(-limit, limit)     # contrast
    beta = rng.uniform(-limit, limit)            # brightness
    if image.dtype == np.uint8:
        out = image.astype(np.float32) * alpha + beta * 255.0
        return np.clip(out, 0, 255).astype(np.uint8)
    return np.clip(image * alpha + beta, 0.0, 1.0)


def random_gamma(image, rng, gamma_range: Tuple[float, float] = (80, 120),
                 p: float = 0.5):
    if rng.random() >= p:
        return image
    gamma = rng.uniform(*gamma_range) / 100.0
    if image.dtype == np.uint8:
        out = ((image.astype(np.float32) / 255.0) ** gamma) * 255.0
        return np.clip(out, 0, 255).astype(np.uint8)
    return np.clip(image, 0.0, 1.0) ** gamma


def hsv_jitter(image, rng, hue_limit: int = 20, sat_limit: int = 30,
               val_limit: int = 20, p: float = 0.5):
    """uint8 RGB HSV jitter: hue shifted mod 180, saturation and value
    shifted and clipped, in cv2's 8-bit HSV."""
    if rng.random() >= p:
        return image
    if image.dtype != np.uint8:
        raise ValueError(f"hsv_jitter takes uint8 RGB, got {image.dtype}")
    dh = int(rng.integers(-hue_limit, hue_limit + 1))
    ds = int(rng.integers(-sat_limit, sat_limit + 1))
    dv = int(rng.integers(-val_limit, val_limit + 1))
    return hsv_jitter_u8(image, dh, ds, dv)


def depth_strip_paste(image, depth, rng):
    """Copy a random vertical depth band into all RGB channels
    (ref base_dataset.py:48-58; applied every 4th training sample)."""
    H, W = image.shape[:2]
    alpha = rng.random()
    beta = rng.random()
    l = int(alpha * W)
    w = int(max((W - alpha * W) * beta * 0.75, 1))
    band = depth[:, l:l + w]
    image = image.copy()
    if image.dtype == np.uint8 and band.dtype != np.uint8:
        band = np.clip(band, 0, 255).astype(np.uint8)
    for c in range(3):
        image[:, l:l + w, c] = band
    return image


def to_float_chw_free(image):
    """uint8/float HWC -> float32 HWC in [0,1] (the layout stays HWC: the
    train step takes NHWC batches)."""
    if image.dtype == np.uint8:
        return image.astype(np.float32) / 255.0
    return image.astype(np.float32)


@dataclass
class AugmentPolicy:
    """Composable augmentation policy.

    Thread-safe: carries no mutable state. The v1 depth-strip trick fires on
    every `depth_strip_every`-th sample index (pass `sample_index`), mirroring
    the reference's per-worker counter (base_dataset.py:48) without shared
    state across loader threads.
    """
    crop_h: int
    crop_w: int
    mode: str = "v2"                # "v1" train | "v2" train | "eval"
    flip_p: float = 0.5
    depth_strip_every: int = 4      # v1 only; 0 disables
    # "float32": images leave as float32 in [0,1] (reference ToTensor
    # semantics). "uint8": images stay uint8 and the train step normalises
    # them on the device (train/step.py _image): 4x fewer host-to-device
    # bytes.
    output_dtype: str = "float32"

    def __call__(self, image, depth, rng: np.random.Generator,
                 sample_index: Optional[int] = None):
        """image uint8 HWC RGB, depth float32 HW -> (float32 HWC, float32 HW)."""
        if self.mode == "eval":
            return self._out(image), depth.astype(np.float32)

        if self.mode == "v1":
            if self.depth_strip_every:
                strip = (sample_index % self.depth_strip_every == 0
                         if sample_index is not None
                         else rng.random() < 1.0 / self.depth_strip_every)
                if strip:
                    image = depth_strip_paste(image, depth, rng)
            if rng.random() < self.flip_p:
                image, depth = hflip(image, depth)
            image, depth = random_crop(image, depth, self.crop_h, self.crop_w,
                                       rng)
        else:  # v2
            image, depth = center_crop(image, depth, self.crop_h, self.crop_w)

        image = random_brightness_contrast(image, rng)
        image = random_gamma(image, rng)
        image = hsv_jitter(image, rng)
        return self._out(image), depth.astype(np.float32)

    def _out(self, image):
        if self.output_dtype == "uint8":
            if image.dtype == np.uint8:
                return image
            # float sources (already [0,1]) quantize exactly iff they came
            # from uint8; guard against silent precision loss otherwise
            q = np.round(image * 255.0)
            if not np.array_equal(q / 255.0, image):
                raise ValueError("output_dtype='uint8' on a non-uint8-"
                                 "sourced float image would quantize it")
            return q.astype(np.uint8)
        return to_float_chw_free(image)
