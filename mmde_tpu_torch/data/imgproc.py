"""The cv2 image operations of the JAX package's readers, in numpy.

Each function is the cv2 call named in its docstring at the arguments the
readers use (mmde_tpu/data/datasets.py, mixed.py, augment.py, void_v3.py,
void_pickle.py), so that the port imports no cv2. The arithmetic
follows cv2's own where a reader's result depends on it:

  * `resize_linear` on uint8 uses cv2's 11-bit fixed-point weights and its
    vectorised rounding ((S0 >> 4) * b0 >> 16 plus the same for S1, then
    (+ 2) >> 2): bitwise with cv2 (rounding the float result instead
    differs by 1 at ~12.8 % of the values);
  * `rgb_to_hsv_u8` uses cv2's 12-bit division tables: bitwise;
  * `hsv_to_rgb_u8` is cv2's float sector formula (s and v scaled by
    float32(1/255), the 1 - s*x terms fused, times 255), truncated for the
    first multiple of 32 pixels of each row and rounded for the rest, as
    the vector and scalar paths of cv2's AVX2 build split a row: bitwise on
    every (h, s, v); both HSV conversions run in csrc/preprocess.cpp;
  * `optimal_new_camera_matrix` (alpha 0) undistorts cv2's 9 x 9 grid of
    float32 points by 5 fixed-point iterations in float64 and takes the
    inner rectangle of the float64 points, as cv2 5 does: equal;
  * `undistort_rectify_maps` is the closed form in float64 stored float32
    (equal to cv2 5's maps at VOID's size; older cv2 sums a row's steps
    incrementally and lands within ~3e-5 px);
  * `undistort` is cv2.undistort: its maps rounded to 1/32 px and its
    fixed-point bilinear remap (bitwise on uint8), where the VOID reader's
    own undistortion (`remap` on the float maps) is the JAX package's.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from mmde_tpu_torch.data import native


# ------------------------------------------------------------- resize --

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
    of a float array, 2-D or HWC: the horizontal pass, then the vertical
    one, in float32."""
    img = np.asarray(img, np.float32)
    x0, x1, wx = _linear_taps(width, img.shape[1])
    y0, y1, wy = _linear_taps(height, img.shape[0])
    tail = (None,) * (img.ndim - 2)
    wx = wx[(None, slice(None)) + tail]
    wy = wy[(slice(None), None) + tail]
    rows = img[:, x0] * (1.0 - wx) + img[:, x1] * wx
    out = rows[y0] * (1.0 - wy) + rows[y1] * wy
    return out.astype(np.float32)


def _fixed_taps(n_out: int, n_in: int):
    """cv2's fixed-point taps: f = float32((x + 0.5) * n_in / n_out - 0.5),
    i = floor(f), the weights round((1 - frac) * 2048) and
    round(frac * 2048) in float32."""
    f = ((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    frac = (f - i0.astype(np.float32)).astype(np.float32)
    return i0, frac


def _coef(frac: np.ndarray):
    a0 = np.rint((np.float32(1) - frac) * np.float32(2048)).astype(np.int64)
    a1 = np.rint(frac * np.float32(2048)).astype(np.int64)
    return a0, a1


def _resize_u8(img: np.ndarray, width: int, height: int) -> np.ndarray:
    h_in, w_in = img.shape[:2]
    src = img.reshape(h_in, w_in, -1).astype(np.int64)
    # horizontal: the taps clamped into the image, one tap past the right
    sx, fx = _fixed_taps(width, w_in)
    low, high = sx < 0, sx >= w_in - 1
    fx[low | high] = 0
    sx[low] = 0
    sx[high] = w_in - 1
    a0, a1 = _coef(fx)
    rows = (src[:, sx] * a0[None, :, None]
            + src[:, np.minimum(sx + 1, w_in - 1)] * a1[None, :, None])
    # vertical: the rows clipped, the weights kept (cv2 does not reset them)
    sy, fy = _fixed_taps(height, h_in)
    b0, b1 = _coef(fy)
    s0 = rows[np.clip(sy, 0, h_in - 1)] >> 4
    s1 = rows[np.clip(sy + 1, 0, h_in - 1)] >> 4
    out = (((s0 * b0[:, None, None]) >> 16)
           + ((s1 * b1[:, None, None]) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8).reshape(
        (height, width) + img.shape[2:])


def resize_linear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """`cv2.resize(img, (width, height))` (INTER_LINEAR) of a 2-D or HWC
    array: uint8 in cv2's fixed point (bitwise), any other type in float32
    (within 1e-5 of cv2 on values of a few units)."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return _resize_u8(img, width, height)
    return resize_bilinear(img, width, height)


def resize_nearest(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """`cv2.resize(img, (width, height), interpolation=INTER_NEAREST)`:
    src[min(floor(i * n_in / n_out), n_in - 1)] along each axis."""
    img = np.asarray(img)
    h_in, w_in = img.shape[:2]
    ys = np.minimum(np.floor(np.arange(height) * (h_in / height)
                             ).astype(np.int64), h_in - 1)
    xs = np.minimum(np.floor(np.arange(width) * (w_in / width)
                             ).astype(np.int64), w_in - 1)
    return np.ascontiguousarray(img[ys][:, xs])


# ---------------------------------------------------------------- HSV --

def rgb_to_hsv_u8(rgb: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(rgb, COLOR_RGB2HSV) of uint8 (..., W, 3): H in 0-179, S
    and V in 0-255, from cv2's 12-bit division tables (in
    csrc/preprocess.cpp)."""
    return native.rgb_to_hsv_u8(rgb)


def hsv_to_rgb_u8(hsv: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(hsv, COLOR_HSV2RGB) of uint8 (..., W, 3) (H in 0-179),
    row by row as cv2 does it: s and v times float32(1/255), cv2's sector
    table with the 1 - s*x terms fused, times 255; truncated for the first
    32 * k pixels of each row (the vector path of cv2's AVX2 build), rounded
    for the rest (the scalar path). In csrc/preprocess.cpp."""
    return native.hsv_to_rgb_u8(hsv)


def hsv_jitter_u8(rgb: np.ndarray, dh: int, ds: int, dv: int) -> np.ndarray:
    """hsv_to_rgb_u8 of rgb_to_hsv_u8(rgb) with the hue shifted by dh mod
    180 and the saturation and value by ds and dv, clipped to 0-255: one
    pass over the pixels."""
    return native.hsv_jitter_u8(rgb, dh, ds, dv)


# -------------------------------------------------------- undistortion --

def _undistort_points(u: np.ndarray, v: np.ndarray, K: np.ndarray,
                      dist: np.ndarray, iters: int = 5):
    """cv2.undistortPoints without R / P: pixel -> normalised coordinates
    by `iters` fixed-point iterations of the radtan model (k1, k2, p1, p2,
    k3), in float64."""
    k1, k2, p1, p2, k3 = (list(np.asarray(dist, np.float64).reshape(-1))
                          + [0.0] * 5)[:5]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    x0 = x = (u - cx) * (1.0 / fx)
    y0 = y = (v - cy) * (1.0 / fy)
    for _ in range(iters):
        r2 = x * x + y * y
        icdist = 1.0 / (1 + ((k3 * r2 + k2) * r2 + k1) * r2)
        if np.any(icdist < 0):
            raise ValueError("distortion model folds over inside the image")
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (x0 - dx) * icdist
        y = (y0 - dy) * icdist
    return x, y


def optimal_new_camera_matrix(K: np.ndarray, dist: np.ndarray,
                              size: Tuple[int, int], alpha: float = 0
                              ) -> np.ndarray:
    """cv2.getOptimalNewCameraMatrix(K, dist, (w, h), 0)[0]: the camera
    matrix whose image holds only valid pixels (the largest rectangle
    inside the undistorted border of cv2's 9 x 9 float32 grid). Only
    alpha 0 is supported (what the readers use)."""
    if alpha != 0:
        raise NotImplementedError(
            f"optimal_new_camera_matrix: alpha {alpha} (only 0)")
    w, h = size
    n = 9
    j, i = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    px = (i.astype(np.float32) * np.float32(w - 1) / np.float32(n - 1))
    py = (j.astype(np.float32) * np.float32(h - 1) / np.float32(n - 1))
    # rows of the grid run along y, columns along x; the rectangle is
    # taken from the float64 points
    x, y = _undistort_points(px.astype(np.float64), py.astype(np.float64),
                             np.asarray(K, np.float64), dist)
    x0, x1 = float(x[:, 0].max()), float(x[:, -1].min())
    y0, y1 = float(y[0, :].max()), float(y[-1, :].min())
    fx = (w - 1) / (x1 - x0)
    fy = (h - 1) / (y1 - y0)
    return np.array([[fx, 0.0, -fx * x0], [0.0, fy, -fy * y0],
                     [0.0, 0.0, 1.0]])


def _rectify_uv(K: np.ndarray, dist: np.ndarray, new_K: np.ndarray,
                size: Tuple[int, int]):
    """Source pixel (u, v) in float64 of every output pixel: back-project
    through new_K, apply the radtan model, project through K."""
    w, h = size
    k1, k2, p1, p2, k3 = (list(np.asarray(dist, np.float64).reshape(-1))
                          + [0.0] * 5)[:5]
    ir = np.linalg.inv(np.asarray(new_K, np.float64))
    jj, ii = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    X = ir[0, 0] * jj + ir[0, 1] * ii + ir[0, 2]
    Y = ir[1, 0] * jj + ir[1, 1] * ii + ir[1, 2]
    W = ir[2, 0] * jj + ir[2, 1] * ii + ir[2, 2]
    x, y = X / W, Y / W
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    xy2 = 2 * x * y
    kr = 1 + ((k3 * r2 + k2) * r2 + k1) * r2
    u = K[0, 0] * (x * kr + p1 * xy2 + p2 * (r2 + 2 * x2)) + K[0, 2]
    v = K[1, 1] * (y * kr + p1 * (r2 + 2 * y2) + p2 * xy2) + K[1, 2]
    return u, v


def undistort_rectify_maps(K: np.ndarray, dist: np.ndarray,
                           new_K: np.ndarray, size: Tuple[int, int]):
    """cv2.initUndistortRectifyMap(K, dist, None, new_K, (w, h),
    CV_32FC1): for every output pixel, back-project through new_K, apply
    the radtan model and project through K (float64), stored float32."""
    u, v = _rectify_uv(K, dist, new_K, size)
    return u.astype(np.float32), v.astype(np.float32)


def remap(img: np.ndarray, mapx: np.ndarray, mapy: np.ndarray) -> np.ndarray:
    """cv2.remap INTER_LINEAR, BORDER_CONSTANT 0 of uint8 (HW / HWC) or
    float32 HW on float maps, in csrc/preprocess.cpp."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return native.remap_u8(img, mapx, mapy)
    if img.dtype == np.float32 and img.ndim == 2:
        return native.remap_f32(img, mapx, mapy)
    raise ValueError(f"remap takes uint8 or 2-D float32, got {img.dtype} "
                     f"{img.shape}")


_TAB = 32       # cv2's INTER_TAB_SIZE: fixed-point maps in 1/32 px


def undistort(img: np.ndarray, K: np.ndarray, dist: np.ndarray,
              new_K: np.ndarray) -> np.ndarray:
    """cv2.undistort(img, K, dist, None, new_K) of uint8 (HW / HWC) or
    float32: cv2's fixed-point maps (source positions rounded to 1/32 px)
    and its bilinear remap on them, BORDER_CONSTANT 0; for uint8 the
    weights in 15-bit fixed point, the sum rounded, as cv2 does."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    u, v = _rectify_uv(K, dist, new_K, (w, h))
    iu, iv = np.rint(u * _TAB).astype(np.int64), np.rint(v * _TAB).astype(
        np.int64)
    x0, y0 = iu >> 5, iv >> 5
    ax = (iu & (_TAB - 1)).astype(np.float32) / np.float32(_TAB)
    ay = (iv & (_TAB - 1)).astype(np.float32) / np.float32(_TAB)
    src = img.reshape(h, w, -1)
    one = np.float32(1)
    taps = ((y0, x0, (one - ay) * (one - ax)), (y0, x0 + 1, (one - ay) * ax),
            (y0 + 1, x0, ay * (one - ax)), (y0 + 1, x0 + 1, ay * ax))
    acc = None
    for ys, xs, wt in taps:
        inside = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
        val = np.where(inside[..., None],
                       src[np.clip(ys, 0, h - 1), np.clip(xs, 0, w - 1)], 0)
        if img.dtype == np.uint8:
            term = val.astype(np.int64) * np.rint(
                wt * 32768).astype(np.int64)[..., None]
        else:
            term = val.astype(np.float32) * wt[..., None]
        acc = term if acc is None else acc + term
    if img.dtype == np.uint8:
        out = np.clip((acc + (1 << 14)) >> 15, 0, 255).astype(np.uint8)
    else:
        out = acc.astype(img.dtype)
    return out.reshape(img.shape)
