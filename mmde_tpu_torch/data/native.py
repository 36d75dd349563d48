"""ctypes bindings of the port's host image library, csrc/preprocess.cpp.

Counterpart of mmde_tpu/native/__init__.py: `remap_u8`, `remap_f32`,
`normalize_crop_u8` and `depth_u16_to_meters` with the same semantics, plus
the decoders' sequential parts that codec.py drives (`png_unfilter`,
`jpeg_info`, `jpeg_decode`) and cv2's 8-bit HSV conversions that imgproc
and the augmentation's jitter call (`rgb_to_hsv_u8`, `hsv_to_rgb_u8`,
`hsv_jitter_u8`). The library is built with g++ into
mmde_tpu_torch/_build/ the first time a function is called (never at
import), under a lock; its file name carries a hash of the source and the
flags, so an edited source is rebuilt and a stale library is never loaded.
There is no fallback: a failed build raises with the compiler's output.
The calls release the interpreter lock (ctypes.CDLL), so loader threads
decode side by side.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Tuple

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "preprocess.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
# no -march=native: every x86-64 host computes the same bits;
# -ffp-contract=off keeps a compiler that targets FMA from fusing products
GXX_FLAGS = ["-O3", "-fPIC", "-shared", "-pthread", "-std=c++17",
             "-ffp-contract=off"]

_LOCK = threading.Lock()
_LIB = [None]

_F32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_U8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_U16 = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
_INT = ctypes.c_int
_INTP = ctypes.POINTER(ctypes.c_int)


def library_path() -> str:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libmmde_preprocess_{h.hexdigest()[:16]}.so")


def _build() -> str:
    path = library_path()
    if os.path.isfile(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = ["g++"] + GXX_FLAGS + [SOURCE, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError(
            f"g++ not found: mmde_tpu_torch's image library "
            f"({SOURCE}) is built from source at first use") from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"g++ failed (exit {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, path)       # atomic: concurrent builds both succeed
    return path


def load() -> ctypes.CDLL:
    """The library, built first if needed."""
    with _LOCK:
        if _LIB[0] is not None:
            return _LIB[0]
        lib = ctypes.CDLL(_build())
        lib.mmde_remap_u8.argtypes = [
            _U8, _INT, _INT, _INT, _F32, _F32, _U8, _INT, _INT, _INT]
        lib.mmde_remap_u8.restype = None
        lib.mmde_remap_f32.argtypes = [
            _F32, _INT, _INT, _F32, _F32, _F32, _INT, _INT, _INT]
        lib.mmde_remap_f32.restype = None
        lib.mmde_normalize_crop_u8.argtypes = [
            _U8, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _F32, _INT]
        lib.mmde_normalize_crop_u8.restype = None
        lib.mmde_depth_u16_to_m.argtypes = [_U16, _INT, _F32, _INT]
        lib.mmde_depth_u16_to_m.restype = None
        lib.mmde_png_unfilter.argtypes = [_U8, _INT, _INT, _INT, _U8]
        lib.mmde_png_unfilter.restype = _INT
        lib.mmde_jpeg_info.argtypes = [_U8, ctypes.c_int64, _INTP, _INTP,
                                       _INTP]
        lib.mmde_jpeg_info.restype = _INT
        lib.mmde_jpeg_decode.argtypes = [_U8, ctypes.c_int64, _U8, _INT,
                                         _INT, _INT]
        lib.mmde_jpeg_decode.restype = _INT
        lib.mmde_rgb_to_hsv_u8.argtypes = [_U8, _INT, _INT, _U8]
        lib.mmde_rgb_to_hsv_u8.restype = None
        lib.mmde_hsv_to_rgb_u8.argtypes = [_U8, _INT, _INT, _U8]
        lib.mmde_hsv_to_rgb_u8.restype = None
        lib.mmde_hsv_jitter_u8.argtypes = [_U8, _INT, _INT, _INT, _INT, _INT,
                                           _U8]
        lib.mmde_hsv_jitter_u8.restype = None
        _LIB[0] = lib
        return lib


def _maps(mapx: np.ndarray, mapy: np.ndarray):
    mapx = np.ascontiguousarray(mapx, np.float32)
    mapy = np.ascontiguousarray(mapy, np.float32)
    if mapx.ndim != 2 or mapx.shape != mapy.shape:
        raise ValueError(f"maps of shapes {mapx.shape} / {mapy.shape}")
    return mapx, mapy


def remap_u8(img: np.ndarray, mapx: np.ndarray, mapy: np.ndarray,
             n_threads: int = 4) -> np.ndarray:
    """Bilinear remap of uint8 HW or HWC (cv2.remap INTER_LINEAR,
    BORDER_CONSTANT 0)."""
    lib = load()
    img = np.ascontiguousarray(img, np.uint8)
    mapx, mapy = _maps(mapx, mapy)
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    oh, ow = mapx.shape
    out = np.empty((oh, ow, ch) if img.ndim == 3 else (oh, ow), np.uint8)
    lib.mmde_remap_u8(img.reshape(h, w, ch), h, w, ch, mapx, mapy,
                      out.reshape(oh, ow, ch), oh, ow, n_threads)
    return out


def remap_f32(img: np.ndarray, mapx: np.ndarray, mapy: np.ndarray,
              n_threads: int = 4) -> np.ndarray:
    """Bilinear remap of float32 HW (depth maps)."""
    lib = load()
    img = np.ascontiguousarray(img, np.float32)
    if img.ndim != 2:
        raise ValueError(f"remap_f32 takes HW, got {img.shape}")
    mapx, mapy = _maps(mapx, mapy)
    h, w = img.shape
    oh, ow = mapx.shape
    out = np.empty((oh, ow), np.float32)
    lib.mmde_remap_f32(img, h, w, mapx, mapy, out, oh, ow, n_threads)
    return out


def normalize_crop_u8(img: np.ndarray, top: int, left: int, oh: int, ow: int,
                      n_threads: int = 4) -> np.ndarray:
    """uint8 HWC -> float32 HWC / 255 with a crop, in one pass."""
    lib = load()
    img = np.ascontiguousarray(img, np.uint8)
    h, w, ch = img.shape
    if top < 0 or left < 0 or top + oh > h or left + ow > w:
        raise ValueError(f"crop ({top}, {left}, {oh}, {ow}) outside {h}x{w}")
    out = np.empty((oh, ow, ch), np.float32)
    lib.mmde_normalize_crop_u8(img, h, w, ch, top, left, oh, ow, out,
                               n_threads)
    return out


def depth_u16_to_meters(raw: np.ndarray, n_threads: int = 2) -> np.ndarray:
    """uint16 depth payload -> float32 meters (/256/1000, VOID's
    convention)."""
    lib = load()
    raw = np.ascontiguousarray(raw, np.uint16)
    out = np.empty(raw.shape, np.float32)
    lib.mmde_depth_u16_to_m(raw.reshape(-1), raw.size, out.reshape(-1),
                            n_threads)
    return out


def png_unfilter(raw: np.ndarray, rows: int, rowbytes: int,
                 bpp: int) -> np.ndarray:
    """Undo PNG's per-row filters: `raw` is the inflated image data (rows x
    (1 + rowbytes) bytes), `bpp` the bytes of one pixel (1 or more).
    Returns (rows, rowbytes) uint8."""
    lib = load()
    raw = np.ascontiguousarray(raw, np.uint8).reshape(-1)
    if raw.size < rows * (rowbytes + 1):
        raise ValueError(f"PNG image data too short: {raw.size} bytes for "
                         f"{rows} rows of {rowbytes}")
    out = np.empty((rows, rowbytes), np.uint8)
    if lib.mmde_png_unfilter(raw, rows, rowbytes, max(bpp, 1), out) != 0:
        raise ValueError("PNG row with a filter type outside 0-4")
    return out


def _rgb_rows(img: np.ndarray) -> Tuple[np.ndarray, int, int]:
    """uint8 (..., W, 3) as C-contiguous rows of W pixels."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim < 2 or img.shape[-1] != 3:
        raise ValueError(f"takes (..., W, 3) uint8, got {img.shape}")
    cols = img.shape[-2] if img.ndim >= 3 else 1
    return img, img.size // (3 * cols), cols


def rgb_to_hsv_u8(rgb: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(rgb, COLOR_RGB2HSV) of uint8 (..., W, 3)."""
    lib = load()
    rgb, rows, cols = _rgb_rows(rgb)
    out = np.empty_like(rgb)
    lib.mmde_rgb_to_hsv_u8(rgb, rows, cols, out)
    return out


def hsv_to_rgb_u8(hsv: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(hsv, COLOR_HSV2RGB) of uint8 (..., W, 3), each row
    split where cv2's vector path splits it."""
    lib = load()
    hsv, rows, cols = _rgb_rows(hsv)
    out = np.empty_like(hsv)
    lib.mmde_hsv_to_rgb_u8(hsv, rows, cols, out)
    return out


def hsv_jitter_u8(rgb: np.ndarray, dh: int, ds: int, dv: int
                  ) -> np.ndarray:
    """RGB -> HSV, hue + dh mod 180, saturation / value + ds / dv clipped,
    -> RGB, in one pass (cv2's conversions)."""
    lib = load()
    rgb, rows, cols = _rgb_rows(rgb)
    out = np.empty_like(rgb)
    lib.mmde_hsv_jitter_u8(rgb, rows, cols, dh, ds, dv, out)
    return out


# mmde_jpeg_info / mmde_jpeg_decode status codes
JPEG_STATUS = {
    -1: (ValueError, "corrupt or truncated JPEG"),
    -2: (NotImplementedError, "progressive JPEG (SOF2) is not supported"),
    -3: (NotImplementedError, "arithmetic-coded JPEG is not supported"),
    -4: (NotImplementedError, "12-bit JPEG is not supported (8-bit only)"),
    -5: (NotImplementedError, "CMYK / 4-component JPEG is not supported "
                              "(1 or 3 components)"),
    -6: (NotImplementedError, "JPEG sampling factors above 2 are not "
                              "supported"),
    -7: (NotImplementedError, "lossless / hierarchical JPEG is not "
                              "supported"),
}


def _jpeg_check(status: int, what: str) -> None:
    if status != 0:
        exc, msg = JPEG_STATUS.get(status, (ValueError, f"status {status}"))
        raise exc(f"{what}: {msg}")


def jpeg_info(data: np.ndarray, what: str = "JPEG") -> Tuple[int, int, int]:
    """(height, width, components) of a JPEG stream (uint8 array)."""
    lib = load()
    data = np.ascontiguousarray(data, np.uint8)
    h, w, c = _INT(), _INT(), _INT()
    _jpeg_check(lib.mmde_jpeg_info(data, data.size, ctypes.byref(h),
                                   ctypes.byref(w), ctypes.byref(c)), what)
    return h.value, w.value, c.value


def jpeg_decode(data: np.ndarray, what: str = "JPEG") -> np.ndarray:
    """Decode a JPEG stream: (H, W) uint8 for grey, (H, W, 3) RGB for
    colour."""
    lib = load()
    data = np.ascontiguousarray(data, np.uint8)
    h, w, c = jpeg_info(data, what)
    out = np.empty((h, w) if c == 1 else (h, w, 3), np.uint8)
    _jpeg_check(lib.mmde_jpeg_decode(data, data.size, out, h, w, c), what)
    return out
