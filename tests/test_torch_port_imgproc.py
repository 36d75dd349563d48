"""PyTorch port: the cv2 image operations of the readers (data.imgproc) and
the host library's build (data.native), against cv2 and the JAX package.

`resize_linear` on uint8 is bitwise with cv2.resize (INTER_LINEAR: cv2's
11-bit weights and its vector path's rounding), on float within 1e-5;
`resize_nearest`, `rgb_to_hsv_u8` and `hsv_to_rgb_u8` are bitwise;
`optimal_new_camera_matrix` within 1e-9 relative of
cv2.getOptimalNewCameraMatrix (measured: equal), the undistortion maps
within 1e-4 px of cv2.initUndistortRectifyMap (measured: equal at 640 x
480); the VOID reader's undistortion (those maps, the native remap) within
1 LSB (uint8) and 1e-3 relative (depth) of the JAX package's
_SceneCache.undistort, the port's remap bitwise the JAX package's native
remap (one C++ source, the same compiler flags but -ffp-contract=off);
`undistort` bitwise cv2.undistort (uint8 and float32). A failed build
raises with the compiler's output.
"""
import os

import cv2
import numpy as np
import pytest

from mmde_tpu import native as jnative
from mmde_tpu.data.void_v3 import Calibration, _SceneCache
from mmde_tpu_torch.data import imgproc, native
from mmde_tpu_torch.testing import VOID_K

from mmde_tpu_torch.testing import set_test_threads

set_test_threads()

# VOID-sized radtan coefficients: k1, k2, p1, p2, k3
DISTS = [np.array([0.0205, -0.0473, 0.00062, -0.00041, 0.0089]),
         np.array([0.0366, 0.0022, 0.0022, -0.0032, 0.0007]),
         np.array([-0.3, 0.09, 0.0005, -0.0003, -0.01])]


@pytest.mark.parametrize("src,dst", [((100, 130), (96, 128)),
                                     ((375, 1242), (352, 1216)),
                                     ((37, 53), (61, 29)),
                                     ((48, 64), (480, 640)),
                                     ((60, 80), (30, 40)),
                                     ((7, 9), (13, 17))])
def test_resizes_are_cv2s(src, dst):
    rng = np.random.default_rng(0)
    for shape in (src, src + (3,)):
        img = rng.integers(0, 256, shape, np.uint8)
        want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
        got = imgproc.resize_linear(img, dst[1], dst[0])
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        f = rng.uniform(0.5, 9.0, shape).astype(np.float32)
        np.testing.assert_allclose(
            imgproc.resize_linear(f, dst[1], dst[0]),
            cv2.resize(f, dst[::-1], interpolation=cv2.INTER_LINEAR),
            rtol=0, atol=1e-5)
        for a in (img, f):
            np.testing.assert_array_equal(
                imgproc.resize_nearest(a, dst[1], dst[0]),
                cv2.resize(a, dst[::-1], interpolation=cv2.INTER_NEAREST))


def test_hsv_conversions_are_cv2s_bitwise():
    """RGB -> HSV on 786k random pixels; HSV -> RGB on every hue and
    saturation at every 3rd value, on 786k random triples, and on rows
    whose widths leave pixels to cv2's scalar path (48, 61, 5, 1)."""
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (768, 1024, 3), np.uint8)
    np.testing.assert_array_equal(imgproc.rgb_to_hsv_u8(rgb),
                                  cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV))
    h, s, v = np.meshgrid(np.arange(180), np.arange(256),
                          np.arange(0, 256, 3), indexing="ij")
    grid = np.stack([h, s, v], -1).reshape(1, -1, 3).astype(np.uint8)
    rand = np.stack([rng.integers(0, 180, 786432),
                     rng.integers(0, 256, 786432),
                     rng.integers(0, 256, 786432)], -1
                    ).reshape(768, 1024, 3).astype(np.uint8)
    odd = [rand[:16, :w] for w in (48, 61, 5, 1)]
    for hsv in [grid, rand] + odd:
        hsv = np.ascontiguousarray(hsv)
        np.testing.assert_array_equal(imgproc.hsv_to_rgb_u8(hsv),
                                      cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


@pytest.mark.parametrize("di", range(len(DISTS)))
def test_camera_matrix_and_maps_are_cv2s(di):
    dist = DISTS[di]
    want, _ = cv2.getOptimalNewCameraMatrix(VOID_K, dist, (640, 480), 0)
    got = imgproc.optimal_new_camera_matrix(VOID_K, dist, (640, 480))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)
    mx, my = imgproc.undistort_rectify_maps(VOID_K, dist, want, (640, 480))
    wx, wy = cv2.initUndistortRectifyMap(VOID_K, dist, None, want,
                                         (640, 480), cv2.CV_32FC1)
    assert mx.dtype == np.float32
    np.testing.assert_allclose(mx, wx, rtol=0, atol=1e-4)
    np.testing.assert_allclose(my, wy, rtol=0, atol=1e-4)
    with pytest.raises(NotImplementedError, match="alpha"):
        imgproc.optimal_new_camera_matrix(VOID_K, dist, (640, 480), 1)


def test_undistort_and_remap_are_the_jax_packages_and_cv2s():
    """The reader's undistortion of a 480 x 640 frame and depth map against
    the JAX _SceneCache.undistort (cv2 maps, the JAX native remap); the
    remap alone bitwise on the same maps, u8 HWC / HW and f32, with
    samples past the border; `undistort` against cv2.undistort."""
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (480, 640, 3), np.uint8)
    depth = rng.uniform(0.3, 5.0, (480, 640)).astype(np.float32)
    sc = _SceneCache.__new__(_SceneCache)
    sc.K, sc._maps = VOID_K, None
    sc.calib = Calibration(np.eye(3), np.zeros(3), np.zeros(3), DISTS[0])
    new_K = imgproc.optimal_new_camera_matrix(VOID_K, DISTS[0], (640, 480))
    maps = imgproc.undistort_rectify_maps(VOID_K, DISTS[0], new_K,
                                          (640, 480))
    got = imgproc.remap(img, *maps)
    assert int(np.abs(got.astype(int) - sc.undistort(img)).max()) <= 1
    np.testing.assert_allclose(imgproc.remap(depth, *maps),
                               sc.undistort(depth), rtol=1e-3, atol=0)
    for a in (img, img[..., 1], depth):
        np.testing.assert_array_equal(
            imgproc.undistort(a, VOID_K, DISTS[0], new_K),
            cv2.undistort(a, VOID_K, DISTS[0], None, new_K))
    mx = rng.uniform(-2, 642, (37, 53)).astype(np.float32)
    my = rng.uniform(-2, 482, (37, 53)).astype(np.float32)
    for a in (img, img[..., 0]):
        np.testing.assert_array_equal(native.remap_u8(a, mx, my),
                                      jnative.remap_u8(a, mx, my))
    np.testing.assert_array_equal(native.remap_f32(depth, mx, my),
                                  jnative.remap_f32(depth, mx, my))
    raw = rng.integers(0, 65536, (17, 23), np.uint16)
    np.testing.assert_array_equal(native.depth_u16_to_meters(raw),
                                  jnative.depth_u16_to_meters(raw))
    np.testing.assert_array_equal(native.normalize_crop_u8(img, 3, 5, 7, 9),
                                  jnative.normalize_crop_u8(img, 3, 5, 7, 9))


def test_a_failed_build_raises_with_the_compilers_output(tmp_path,
                                                         monkeypatch):
    """No fallback: a source that does not compile raises RuntimeError
    carrying g++'s message; importing the module builds nothing."""
    bad = tmp_path / "preprocess.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_LIB", [None])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*\n.*\n.*error"):
        native.load()
    assert not os.listdir(tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.remap_u8(np.zeros((2, 2), np.uint8),
                        np.zeros((2, 2), np.float32),
                        np.zeros((2, 2), np.float32))
