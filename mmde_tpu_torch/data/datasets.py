"""Dataset readers: NYU-Depth-V2 (single + paired), KITTI Eigen, imagepath.

Counterpart of mmde_tpu/data/datasets.py without cv2: files through
data.codec (PNG and baseline JPEG), resizes through data.imgproc, the same
draws from the per-sample generator. Capability parity with reference
dataset/:
  * nyudepthv2.py — filename-list loader, BGR->RGB, depth/1000 m, v1
    augmentation (the reference's scale_size branch resizes the *image* into
    the depth slot, nyudepthv2.py:55 — a recorded bug we do not reproduce);
  * nyudepthv2_v2.py — scene-grouped frame pairs with joint horizontal flip;
  * kitti.py — Eigen list, KB crop to 352x1216, depth/256 m;
  * imagepath.py — any folder of jpg/png resized to a multiple of 32
    (inference only).

Samples are numpy dicts in NHWC float [0,1]; batching/prefetch lives in
mmde_tpu_torch.data.loader.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from mmde_tpu_torch.data import augment as aug
from mmde_tpu_torch.data import codec
from mmde_tpu_torch.data.imgproc import resize_linear
from mmde_tpu_torch.data.manifests import (
    FramePair, group_by_scene, make_frame_pairs, read_pair_list)


def imread_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB (cv2.imread then BGR2RGB); FileNotFoundError
    for a missing or unreadable file."""
    return codec.imread_rgb(path)


def imread_depth(path: str) -> np.ndarray:
    """The depth file's samples (IMREAD_UNCHANGED) as float32."""
    return codec.imread_unchanged(path).astype(np.float32)


def kb_crop(img: np.ndarray, out_h: int = 352, out_w: int = 1216) -> np.ndarray:
    """KITTI-benchmark crop (ref kitti.py:38-47 / metrics.py:45-51)."""
    h, w = img.shape[:2]
    top = int(h - out_h)
    left = int((w - out_w) / 2)
    return img[top:top + out_h, left:left + out_w]


class NYUDepthV2:
    """Single-frame NYU loader (ref dataset/nyudepthv2.py)."""

    def __init__(self, data_path: str, filenames_path: str, is_train: bool = True,
                 crop_size: Tuple[int, int] = (448, 576),
                 scale_size: Optional[Tuple[int, int]] = None, seed: int = 0):
        self.is_train = is_train
        self.scale_size = scale_size
        root = os.path.join(data_path, "nyu_depth_v2")
        if not is_train:
            root = os.path.join(root, "official_splits/test")
        self.root = root
        lst = os.path.join(filenames_path, "nyudepthv2",
                           "train_list.txt" if is_train else "test_list.txt")
        self.entries = read_pair_list(lst)
        self.policy = aug.AugmentPolicy(crop_size[0], crop_size[1],
                                        mode="v1" if is_train else "eval")
        self._seed = seed

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        img_rel, gt_rel = self.entries[idx]
        img_path = self.root + img_rel
        gt_path = self.root + gt_rel
        image = imread_rgb(img_path)
        depth = imread_depth(gt_path)
        if self.scale_size:
            image = resize_linear(image, *self.scale_size)
            depth = resize_linear(depth, *self.scale_size)
        rng = np.random.default_rng((self._seed, idx))
        image, depth = self.policy(image, depth, rng, idx)
        depth = depth / 1000.0
        filename = img_path.split("/")[-2] + "_" + img_path.split("/")[-1]
        return {"image": image, "depth": depth, "filename": filename}


class NYUDepthV2Pairs:
    """Scene-paired NYU loader (ref dataset/nyudepthv2_v2.py).

    Both splits read train_list.txt; held-out scenes form the test split
    (base_dataset_v2.py:27-63)."""

    def __init__(self, data_path: str, filenames_path: str, is_train: bool = True,
                 crop_size: Tuple[int, int] = (448, 576), seed: int = 0):
        self.is_train = is_train
        self.root = os.path.join(data_path, "nyu_depth_v2")
        lst = os.path.join(filenames_path, "nyudepthv2", "train_list.txt")
        scenes = group_by_scene(read_pair_list(lst), is_train)
        self._seed = seed
        self.pairs: List[FramePair] = make_frame_pairs(
            scenes, is_train, np.random.default_rng(seed))
        self.policy = aug.AugmentPolicy(crop_size[0], crop_size[1],
                                        mode="v2" if is_train else "eval")

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        p = self.pairs[idx]
        f1 = imread_rgb(self.root + p.frame1)
        d1 = imread_depth(self.root + p.gt1)
        f2 = imread_rgb(self.root + p.frame2)
        d2 = imread_depth(self.root + p.gt2)

        rng = np.random.default_rng((self._seed, idx))
        if self.is_train and rng.random() < 0.5:
            f1, d1 = aug.hflip(f1, d1)
            f2, d2 = aug.hflip(f2, d2)
        f1, d1 = self.policy(f1, d1, rng, idx)
        f2, d2 = self.policy(f2, d2, rng, idx)
        return {"image1": f1, "depth1": d1 / 1000.0, "filename1": p.frame1,
                "image2": f2, "depth2": d2 / 1000.0, "filename2": p.frame2}


class KITTIEigen:
    """KITTI Eigen-benchmark loader with KB crop (ref dataset/kitti.py)."""

    def __init__(self, data_path: str, filenames_path: str, is_train: bool = True,
                 crop_size: Tuple[int, int] = (352, 704),
                 scale_size: Optional[Tuple[int, int]] = None, seed: int = 0):
        self.is_train = is_train
        self.scale_size = scale_size
        self.root = os.path.join(data_path, "kitti")
        lst = os.path.join(filenames_path, "eigen_benchmark",
                           "train_list.txt" if is_train else "test_list.txt")
        self.entries = read_pair_list(lst)
        self.policy = aug.AugmentPolicy(crop_size[0], crop_size[1],
                                        mode="v1" if is_train else "eval")
        self._seed = seed

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        img_rel, gt_rel = self.entries[idx]
        image = imread_rgb(self.root + img_rel)
        depth = imread_depth(self.root + gt_rel)
        image = kb_crop(image)
        depth = kb_crop(depth)
        if self.scale_size:
            image = resize_linear(image, *self.scale_size)
            depth = resize_linear(depth, *self.scale_size)
        rng = np.random.default_rng((self._seed, idx))
        image, depth = self.policy(image, depth, rng, idx)
        depth = depth / 256.0
        filename = (self.root + img_rel).split("/")[-4] + "_" + \
            img_rel.split("/")[-1]
        return {"image": image, "depth": depth, "filename": filename}


class ImageFolder:
    """Inference-only folder loader (ref dataset/imagepath.py): resizes to a
    multiple of 32."""

    def __init__(self, data_path: str):
        self.files = [os.path.join(data_path, f)
                      for f in sorted(os.listdir(data_path))
                      if f.split(".")[-1].lower() in ("jpg", "png", "jpeg")]

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        path = self.files[idx]
        image = imread_rgb(path)
        h, w = image.shape[:2]
        image = resize_linear(image, w // 32 * 32, h // 32 * 32)
        return {"image": image.astype(np.float32) / 255.0,
                "filename": os.path.basename(path)}
