"""VOID raw-release loader: RGB pairs + depth + absolute poses + IMU.

Counterpart of mmde_tpu/data/void_v3.py without cv2 or PIL: frames and
depth through data.codec, the undistortion maps from data.imgproc (cv2's
getOptimalNewCameraMatrix / initUndistortRectifyMap) applied by the
native remap of csrc/preprocess.cpp, the same draws from the per-sample
generator. Capability parity with reference dataset/void_dataset_v3.py
(320 lines):
  * release layout void_release/void_1500/data/<scene>/{image, ground_truth,
    absolute_pose, K.txt} (ref :121-133, :175-182);
  * 16-bit depth PNG / 256 then / 1000 -> meters (ref :21-37, :226-229);
  * per-scene undistortion from calibration.json radtan parameters
    (ref :43-50, :283-304);
  * frame2 = frame1 + U{interval_range} (ref :184-186);
  * relative poses both directions via SE(3) (ref :202-203);
  * IMU: CSV parse, bias subtraction, rotation into the camera frame,
    inter-frame interval slice with per-sample dt (ref :60-87);
  * returns the full multi-modal sample dict (raw + undistorted images and
    depths, T/R/w/axis-angle both directions, IMU interval).

Performance redesign (the reference re-reads and re-transforms the IMU CSV
and re-derives the undistortion maps for EVERY sample, ref :172-173,
:43-50 — its data-pipeline hot spot, SURVEY.md §3.4):
  * IMU streams are parsed + bias-corrected once per scene and cached;
  * undistortion remap grids are computed once per scene and applied by
    the native remap;
  * image/depth/pose file lists are globbed once per scene;
  * IMU intervals are padded to a static max length with an explicit length
    so batches have fixed shapes under jit (vs. pad_sequence at
    train.py:45-61).
"""
from __future__ import annotations

import json
import os
import threading
import warnings
from dataclasses import dataclass
from glob import glob
from typing import Dict, List, Tuple

import numpy as np

from mmde_tpu_torch import geometry as geo
from mmde_tpu_torch.data import augment as aug
from mmde_tpu_torch.data import codec, imgproc
from mmde_tpu_torch.data.manifests import VoidSample, index_void_release


def load_depth_png(path: str) -> np.ndarray:
    """16-bit depth PNG -> float32 (still x1000 scale; ref :21-37)."""
    z = codec.imread_unchanged(path).astype(np.float32) / 256.0
    z[z <= 0] = 0.0
    return z


def load_pose_txt(path: str) -> np.ndarray:
    """3x4 pose file -> 4x4 homogeneous."""
    pose = np.loadtxt(path)
    return np.vstack([pose, [0, 0, 0, 1]])


@dataclass
class Calibration:
    R_c_i: np.ndarray           # body->camera rotation
    bias_acc: np.ndarray
    bias_gyro: np.ndarray
    dist_coeffs: np.ndarray     # cv2 ordering


def load_calibration(path: str, distortion_mode: str = "reference"
                     ) -> Calibration:
    """Parse calibration.json (camera radtan + IMU biases + extrinsics).

    distortion_mode="reference" reproduces the coefficient vector the
    reference builds at void_dataset_v3.py:47 — [k0, p1, p1, p2, k2] (k1 is
    skipped and p1 duplicated); "standard" uses the conventional
    [k0, k1, p1, p2, k2]. The default matches the reference so undistorted
    pixels (and therefore eval numbers) are comparable.
    """
    with open(path) as f:
        calib = json.load(f)
    w_c_i = calib["alignment"]["w_camera_to_body"]
    cam = calib["camera"]
    if distortion_mode == "reference":
        coeffs = [cam["k_0"], cam["p_x"], cam["p_x"], cam["p_y"], cam["k_2"]]
    else:
        coeffs = [cam["k_0"], cam["k_1"], cam["p_x"], cam["p_y"], cam["k_2"]]
    return Calibration(
        R_c_i=geo.exp_so3(w_c_i),
        bias_acc=np.asarray(calib["imu"]["b_a"], np.float64),
        bias_gyro=np.asarray(calib["imu"]["b_g"], np.float64),
        dist_coeffs=np.asarray(coeffs, np.float64),
    )


def load_imu_csv(path: str, calib: Calibration) -> Dict[str, np.ndarray]:
    """Parse a rostopic-echo IMU CSV; subtract biases; rotate acc/gyro into
    the camera frame (ref :60-73). Uses numpy text parsing instead of pandas
    (faster, no per-sample DataFrame)."""
    with open(path) as f:
        header = f.readline().strip().split(",")
        cols = {name: i for i, name in enumerate(header)}
        data = np.loadtxt(f, delimiter=",",
                          usecols=[cols["field.header.stamp"],
                                   cols["field.linear_acceleration.x"],
                                   cols["field.linear_acceleration.y"],
                                   cols["field.linear_acceleration.z"],
                                   cols["field.angular_velocity.x"],
                                   cols["field.angular_velocity.y"],
                                   cols["field.angular_velocity.z"]],
                          ndmin=2)
    ts = data[:, 0] * 1e-9
    acc = (data[:, 1:4] - calib.bias_acc) @ calib.R_c_i.T
    gyro = (data[:, 4:7] - calib.bias_gyro) @ calib.R_c_i.T
    return {"timestamp": ts, "acc": acc, "gyro": gyro}


def imu_interval(imu: Dict[str, np.ndarray], t1: float, t2: float
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Slice [t1, t2] and build (timestamps (n,1), packets (n,7)) where each
    packet is [dt, acc_xyz, gyro_xyz] with dt relative to the previous
    sample (dt[0] from t1) — ref :75-87."""
    sel = (imu["timestamp"] >= t1) & (imu["timestamp"] <= t2)
    ts = imu["timestamp"][sel]
    prev = np.empty_like(ts)
    if len(ts):
        prev[1:] = ts[:-1]
        prev[0] = t1
    dt = (ts - prev).reshape(-1, 1)
    packets = np.concatenate([dt, imu["acc"][sel], imu["gyro"][sel]], axis=1)
    return ts.reshape(-1, 1), packets.astype(np.float32)


class _SceneCache:
    """Per-scene cached state: file lists, intrinsics, undistort maps, IMU."""

    def __init__(self, release_dir: str, raw_dir: str, scene: str,
                 calib: Calibration):
        base = os.path.join(release_dir, scene)
        self.images = sorted(glob(os.path.join(base, "image", "*.png")))
        self.depths = sorted(glob(os.path.join(base, "ground_truth", "*.png")))
        self.poses = sorted(glob(os.path.join(base, "absolute_pose", "*.txt")))
        # VOID release also ships VIO sparse depth + validity maps — the
        # depth-completion modality (optional).
        self.sparse = sorted(glob(os.path.join(base, "sparse_depth", "*.png")))
        self.validity = sorted(glob(os.path.join(base, "validity_map", "*.png")))
        self.K = np.loadtxt(os.path.join(base, "K.txt"), dtype=np.float64)
        self.calib = calib
        self._maps = None
        self._maps_lock = threading.Lock()     # loader threads share a scene
        # IMU source: raw.csv, auto-converted from raw.bag on miss (the
        # reference shells out to `rostopic echo` at void_dataset_v3.py:89-105;
        # we parse the bag natively). A scene with neither file trains with
        # empty IMU tensors — warn loudly instead of failing silently.
        imu_csv = os.path.join(raw_dir, scene, "raw.csv")
        imu_bag = os.path.join(raw_dir, scene, "raw.bag")
        if not os.path.isfile(imu_csv) and os.path.isfile(imu_bag):
            from mmde_tpu_torch.data.rosbag import convert_bag_to_csv
            try:
                n = convert_bag_to_csv(imu_bag, imu_csv)
                print(f"[void_v3] {scene}: converted raw.bag -> raw.csv "
                      f"({n} IMU rows)")
            except Exception as e:     # a bad bag: train without IMU
                warnings.warn(f"[void_v3] {scene}: raw.bag -> raw.csv "
                              f"conversion failed ({e}); IMU will be empty")
        if os.path.isfile(imu_csv):
            self.imu = load_imu_csv(imu_csv, calib)
        else:
            warnings.warn(
                f"[void_v3] scene '{scene}' has no IMU source "
                f"({imu_csv} / raw.bag missing): samples from this scene "
                f"carry zero-length IMU tensors")
            self.imu = None

    def undistort(self, img: np.ndarray) -> np.ndarray:
        """uint8 frame or float32 depth through the scene's maps (built on
        the first call, from the first image's size)."""
        h, w = img.shape[:2]
        with self._maps_lock:
            if self._maps is None:
                new_K = imgproc.optimal_new_camera_matrix(
                    self.K, self.calib.dist_coeffs, (w, h), 0)
                self._maps = imgproc.undistort_rectify_maps(
                    self.K, self.calib.dist_coeffs, new_K, (w, h))
        return imgproc.remap(img, self._maps[0], self._maps[1])

    def stamp(self, order: int) -> float:
        name = os.path.basename(self.images[order])
        return float(name[:-len(".png")])


class VoidV3:
    """Raw VOID release dataset (drop-in capability for void_dataset_v3)."""

    def __init__(self, data_path: str, list_file: str, calibration_path: str,
                 is_train: bool = True, crop_size: Tuple[int, int] = (448, 576),
                 image_interval_range: Tuple[int, int] = (5, 5),
                 imu_max_len: int = 256, seed: int = 0,
                 distortion_mode: str = "reference",
                 load_sparse_depth: bool = False):
        self.load_sparse_depth = load_sparse_depth
        self.release_dir = os.path.join(data_path, "void_release/void_1500/data")
        self.raw_dir = os.path.join(data_path, "void_raw")
        self.is_train = is_train
        self.interval = tuple(image_interval_range)
        self.imu_max_len = imu_max_len
        self.calib = load_calibration(calibration_path, distortion_mode)
        self.samples: List[VoidSample] = index_void_release(
            self.release_dir, list_file, self.interval[1])
        self.policy = aug.AugmentPolicy(crop_size[0], crop_size[1],
                                        mode="v2" if is_train else "eval")
        self.seed = seed
        self._scenes: Dict[str, _SceneCache] = {}
        self._scene_lock = threading.Lock()

    def __len__(self):
        return len(self.samples)

    def _scene(self, name: str) -> _SceneCache:
        # loader threads share this dataset; build each scene cache once
        with self._scene_lock:
            sc = self._scenes.get(name)
            if sc is None:
                sc = _SceneCache(self.release_dir, self.raw_dir, name,
                                 self.calib)
                self._scenes[name] = sc
        return sc

    def _load_frame(self, sc: _SceneCache, order: int):
        image = codec.imread_rgb(sc.images[order])
        depth = load_depth_png(sc.depths[order])
        return (image, depth, sc.undistort(image), sc.undistort(depth),
                load_pose_txt(sc.poses[order]), sc.stamp(order))

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        # per-sample RNG stream: thread-safe and reproducible
        rng = np.random.default_rng((self.seed, idx))
        s = self.samples[idx]
        sc = self._scene(s.scene)
        o1 = s.order
        o2 = o1 + int(rng.integers(self.interval[0], self.interval[1] + 1))

        img1, dep1, img1_u, dep1_u, T01, t1 = self._load_frame(sc, o1)
        img2, dep2, img2_u, dep2_u, T02, t2 = self._load_frame(sc, o2)

        sparse = {}
        if self.load_sparse_depth and sc.sparse:
            sd1 = load_depth_png(sc.sparse[o1]) / 1000.0
            sd2 = load_depth_png(sc.sparse[o2]) / 1000.0
            if self.is_train:  # keep geometry aligned with the center crop
                sd1, sd2 = aug.center_crop(sd1, sd2, self.policy.crop_h,
                                           self.policy.crop_w)
            sparse = {"sparse_depth1": sd1.astype(np.float32),
                      "sparse_depth2": sd2.astype(np.float32)}

        _, T12, R12, w12, aa12 = geo.relative_pose_parts(T01, T02)
        _, T21, R21, w21, aa21 = geo.relative_pose_parts(T02, T01)

        if sc.imu is not None:
            imu_ts, imu_pkts = imu_interval(sc.imu, t1, t2)
        else:
            imu_ts = np.zeros((0, 1))
            imu_pkts = np.zeros((0, 7), np.float32)

        # static-shape padding for jit-compatible batching
        n = min(len(imu_pkts), self.imu_max_len)
        imu_pad = np.zeros((self.imu_max_len, 7), np.float32)
        imu_pad[:n] = imu_pkts[:n]
        ts_pad = np.zeros((self.imu_max_len,), np.float32)
        ts_pad[:n] = imu_ts[:n, 0]

        # depth x1000 scale -> meters (ref :226-229)
        dep1, dep2 = dep1 / 1000.0, dep2 / 1000.0
        dep1_u, dep2_u = dep1_u / 1000.0, dep2_u / 1000.0

        img1_u, dep1_u = self.policy(img1_u, dep1_u, rng, idx)
        img2_u, dep2_u = self.policy(img2_u, dep2_u, rng, idx)

        f32 = lambda x: np.asarray(x, np.float32)
        return {
            "filename": s.file_name, "foldername": s.scene,
            "timestamp1": np.float64(t1), "timestamp2": np.float64(t2),
            "image1_raw": f32(img1) / 255.0, "image2_raw": f32(img2) / 255.0,
            "depth1_raw": f32(dep1), "depth2_raw": f32(dep2),
            "image1": img1_u, "image2": img2_u,
            "depth1": dep1_u, "depth2": dep2_u,
            "T12": f32(T12.reshape(3)), "R12": f32(R12),
            "w12": f32(w12.reshape(3)), "AxisAngle12": f32(aa12.reshape(4)),
            "T21": f32(T21.reshape(3)), "R21": f32(R21),
            "w21": f32(w21.reshape(3)), "AxisAngle21": f32(aa21.reshape(4)),
            "imu_timestamp": ts_pad, "imu_data": imu_pad,
            "imu_len": np.int32(n),
            **sparse,
        }
