"""VOID pickle-based datasets (v1/v2 generations) + offline generator.

Counterpart of mmde_tpu/data/void_pickle.py without cv2: frames through
data.codec, undistortion through data.imgproc and the native remap. The
pickles hold numpy arrays and Python floats only, so either package reads
the other's. Unpickling runs code: read only pickles this project wrote.
Capability parity with:
  * dataset/void.py (v1) / dataset/void_dataset_v2.py (v2) — per-sample
    pickle loaders. v2 pickles already contain undistorted images/depths and
    the loader returns the flattened 12-dim rel_pose (rot9+trans3) and
    axis-angle (ref void_dataset_v2.py:55-110);
  * dataset/gen_data.py + gen_data_train_test_list.py +
    void_dataset/backup/generate_void_pickle.py — offline VOID -> pickle
    preprocessing: IMU transform to camera frame, pairing with a random
    offset, relative pose via inv(p2)·p1, undistortion, per-sample pickle
    dump, and the train/test list mapping.

The pickle schema written by `generate_pickles` is the v2 schema.
"""
from __future__ import annotations

import json
import os
import pickle
from glob import glob
from typing import Dict, List, Optional, Tuple

import numpy as np

from mmde_tpu_torch import geometry as geo
from mmde_tpu_torch.data import augment as aug
from mmde_tpu_torch.data import codec, imgproc
from mmde_tpu_torch.data.void_v3 import (_SceneCache, imu_interval,
                                         load_calibration, load_depth_png,
                                         load_pose_txt)


class VoidPickle:
    """Loader over per-sample pickle files (v2 schema).

    Each pickle holds: image1/image2 (undistorted uint8 HWC RGB),
    depth1/depth2 (float32 HW, x1000 scale), T12/R12/w12/AxisAngle12 (+ the
    21 reverses), imu_timestamp, imu_data, timestamps.
    """

    def __init__(self, list_file: str, is_train: bool = True,
                 crop_size: Tuple[int, int] = (448, 576),
                 imu_max_len: int = 256, seed: int = 0):
        with open(list_file) as f:
            self.files = [l.strip() for l in f if l.strip()]
        self.is_train = is_train
        self.imu_max_len = imu_max_len
        self.policy = aug.AugmentPolicy(crop_size[0], crop_size[1],
                                        mode="v2" if is_train else "eval")
        self._seed = seed

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        with open(self.files[idx], "rb") as f:
            d = pickle.load(f)
        img1, img2 = d["image1"], d["image2"]
        dep1 = d["depth1"].astype(np.float32) / 1000.0
        dep2 = d["depth2"].astype(np.float32) / 1000.0
        rng = np.random.default_rng((self._seed, idx))
        img1, dep1 = self.policy(img1, dep1, rng, idx)
        img2, dep2 = self.policy(img2, dep2, rng, idx)

        R12 = np.asarray(d["R12"], np.float32).reshape(3, 3)
        T12 = np.asarray(d["T12"], np.float32).reshape(3)
        R21 = np.asarray(d["R21"], np.float32).reshape(3, 3)
        T21 = np.asarray(d["T21"], np.float32).reshape(3)
        rel_pose12 = np.concatenate([R12.reshape(-1), T12])   # 12-dim (v2 API)

        imu = np.asarray(d.get("imu_data", np.zeros((0, 7))), np.float32)
        n = min(len(imu), self.imu_max_len)
        imu_pad = np.zeros((self.imu_max_len, 7), np.float32)
        imu_pad[:n] = imu[:n]

        return {
            "image1": img1, "image2": img2,
            "depth1": dep1, "depth2": dep2,
            "R12": R12, "T12": T12, "R21": R21, "T21": T21,
            "rel_pose12": rel_pose12.astype(np.float32),
            "AxisAngle12": np.asarray(d.get("AxisAngle12",
                                            np.zeros(4)), np.float32).reshape(-1),
            "imu_data": imu_pad, "imu_len": np.int32(n),
            "filename": os.path.basename(self.files[idx]),
        }


class VoidPickleV1:
    """v1 pickle loader (ref dataset/void.py).

    Schema: each pickle is a 1-element list whose dict carries DISTORTED
    raw_image1/raw_image2, depth_image1/depth_image2 (x1000 scale),
    rel_pose, imu_data, dt and Rodrigues (ref void.py:84-97). With
    transform=True (the training default) the loader
      * adds gaussian noise (std 0.2) to the IMU stream (ref :111-114);
      * undistorts the stored raw images on the fly with the calibration's
        radtan model via getOptimalNewCameraMatrix(alpha=0) + undistort
        (ref :117-122).
    Unlike the reference (which crashes with transform=False because
    `undistorted_raw1` is unbound, a known defect), transform=False returns
    the raw images as stored.
    """

    def __init__(self, list_file: str, calibration_path: Optional[str] = None,
                 transform: bool = True, imu_noise_std: float = 0.2,
                 imu_max_len: int = 256, seed: int = 0):
        with open(list_file) as f:
            self.files = [l.strip() for l in f if l.strip()]
        self.transform = transform
        self.imu_noise_std = imu_noise_std
        self.imu_max_len = imu_max_len
        self._seed = seed
        self.calib = None
        self.K = None
        if calibration_path:
            with open(calibration_path) as f:
                cam = json.load(f)["camera"]
            self.K = np.array([[cam["f_x"], 0, cam["c_x"]],
                               [0, cam["f_y"], cam["c_y"]],
                               [0, 0, 1]], np.float64)
            # reference v1 ordering (void.py:30): [k0, k1, p1, p2, k2]
            self.dist = np.array([cam["k_0"], cam["k_1"], cam["p_x"],
                                  cam["p_y"], cam["k_2"]], np.float64)
        self._new_K = None

    def __len__(self):
        return len(self.files)

    def _undistort(self, img: np.ndarray) -> np.ndarray:
        """cv2.undistort(img, K, dist, None, new_K), new_K of alpha 0."""
        h, w = img.shape[:2]
        if self._new_K is None:
            self._new_K = imgproc.optimal_new_camera_matrix(
                self.K, self.dist, (w, h), 0)
        return imgproc.undistort(np.asarray(img), self.K, self.dist,
                                 self._new_K)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        with open(self.files[idx], "rb") as f:
            raw = pickle.load(f)
        d = raw[0] if isinstance(raw, (list, tuple)) else raw

        img1 = np.asarray(d["raw_image1"])
        img2 = np.asarray(d["raw_image2"])
        imu = np.asarray(d.get("imu_data", np.zeros((0, 7))), np.float32)

        if self.transform:
            rng = np.random.default_rng((self._seed, idx))
            if imu.size:
                imu = imu + rng.normal(
                    0.0, self.imu_noise_std, imu.shape).astype(np.float32)
            if self.K is not None:
                img1 = self._undistort(img1)
                img2 = self._undistort(img2)

        n = min(len(imu), self.imu_max_len)
        tail = imu.shape[1:] if imu.ndim > 1 else (7,)
        imu_pad = np.zeros((self.imu_max_len,) + tail, np.float32)
        imu_pad[:n] = imu[:n]

        return {
            "image1": np.asarray(img1, np.float32) / 255.0,
            "image2": np.asarray(img2, np.float32) / 255.0,
            "depth1": np.asarray(d["depth_image1"], np.float32) / 1000.0,
            "depth2": np.asarray(d["depth_image2"], np.float32) / 1000.0,
            "rel_pose": np.asarray(d["rel_pose"], np.float32),
            "imu_data": imu_pad, "imu_len": np.int32(n),
            "dt": np.float32(d.get("dt", 0.0)),
            "w": np.asarray(d.get("Rodrigues", np.zeros(3)),
                            np.float32).reshape(-1),
            "filename": os.path.basename(self.files[idx]),
        }


def generate_pickles(data_path: str, calibration_path: str, out_dir: str,
                     scenes: Optional[List[str]] = None,
                     offset_range: Tuple[int, int] = (5, 10),
                     seed: int = 123,
                     limit_per_scene: Optional[int] = None) -> List[str]:
    """Offline VOID release -> per-sample pickle conversion
    (gen_data.py capability): undistort both frames + depths, compute both
    relative poses, slice the IMU interval, dump one pickle per pair.
    Returns the list of written files.
    """
    release = os.path.join(data_path, "void_release/void_1500/data")
    raw = os.path.join(data_path, "void_raw")
    calib = load_calibration(calibration_path)
    rng = np.random.default_rng(seed)
    written: List[str] = []

    scene_names = scenes or sorted(os.listdir(release))
    for scene in scene_names:
        sc = _SceneCache(release, raw, scene, calib)
        os.makedirs(os.path.join(out_dir, scene), exist_ok=True)
        count = 0
        for o1 in range(len(sc.images)):
            off = int(rng.integers(offset_range[0], offset_range[1] + 1))
            o2 = o1 + off
            if o2 >= len(sc.images):
                continue
            img1 = codec.imread_rgb(sc.images[o1])
            img2 = codec.imread_rgb(sc.images[o2])
            dep1 = load_depth_png(sc.depths[o1])
            dep2 = load_depth_png(sc.depths[o2])
            T01 = load_pose_txt(sc.poses[o1])
            T02 = load_pose_txt(sc.poses[o2])
            _, T12, R12, w12, aa12 = geo.relative_pose_parts(T01, T02)
            _, T21, R21, w21, aa21 = geo.relative_pose_parts(T02, T01)
            t1, t2 = sc.stamp(o1), sc.stamp(o2)
            if sc.imu is not None:
                imu_ts, imu_pkts = imu_interval(sc.imu, t1, t2)
            else:
                imu_ts = np.zeros((0, 1))
                imu_pkts = np.zeros((0, 7), np.float32)

            sample = {
                "image1": sc.undistort(img1), "image2": sc.undistort(img2),
                "depth1": sc.undistort(dep1), "depth2": sc.undistort(dep2),
                "T12": T12, "R12": R12, "w12": w12, "AxisAngle12": aa12,
                "T21": T21, "R21": R21, "w21": w21, "AxisAngle21": aa21,
                "timestamp1": t1, "timestamp2": t2,
                "imu_timestamp": imu_ts, "imu_data": imu_pkts,
            }
            path = os.path.join(out_dir, scene, f"{o1:06d}.pickle")
            with open(path, "wb") as f:
                pickle.dump(sample, f)
            written.append(path)
            count += 1
            if limit_per_scene and count >= limit_per_scene:
                break
    return written


def write_split_lists(pickle_dir: str, out_train: str, out_test: str,
                      test_fraction: float = 0.02, seed: int = 0) -> None:
    """Map generated pickles to train/test list files
    (gen_data_train_test_list.py capability)."""
    files = sorted(glob(os.path.join(pickle_dir, "*", "*.pickle")))
    rng = np.random.default_rng(seed)
    test_mask = rng.random(len(files)) < test_fraction
    with open(out_train, "w") as f:
        f.write("\n".join(p for p, t in zip(files, test_mask) if not t))
    with open(out_test, "w") as f:
        f.write("\n".join(p for p, t in zip(files, test_mask) if t))
