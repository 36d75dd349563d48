"""PyTorch port: the PNG / JPEG codec (data.codec, csrc/preprocess.cpp)
against cv2 and PIL.

PNG decoding is bitwise with cv2.imread (IMREAD_COLOR and IMREAD_UNCHANGED)
and with PIL for every colour type and bit depth the codec covers; the
writer's files read back bitwise in both cv2 and the codec, under each row
filter. JPEG decoding is held to cv2.imdecode of cv2.imencode's files at
qualities 75 and 95 in every sampling mode up to 2 x 2, grey, with restart
markers and at odd sizes: max abs <= 2 for 4:4:4 and grey, <= 3 for 4:2:0,
4:2:2 and 4:4:0. Measured on this project's reference machine (cv2 5.0.0,
libjpeg-turbo 3.1.2): 0 everywhere, the decoder being libjpeg's islow IDCT,
fancy upsampling and fixed-point YCbCr. The committed fixtures of
tests/fixtures/jpeg are held to the cv2 decodes saved beside them (what the
card run checks too). Every unsupported variant raises naming itself.
"""
import glob
import io
import os
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from mmde_tpu_torch.data import codec, native

from mmde_tpu_torch.testing import set_test_threads

set_test_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "jpeg")
LIMIT = {"444": 2, "grey": 2, "420": 3, "422": 3, "440": 3}
MODES = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
         "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
         "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
         "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}


def _smooth(rng, h, w, c=3):
    coarse = rng.uniform(0, 255, (h // 8 + 2, w // 8 + 2, c))
    img = cv2.resize(coarse.astype(np.float32), (w, h),
                     interpolation=cv2.INTER_CUBIC).reshape(h, w, c)
    img += rng.normal(0, 12, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _cv2_png(arr):
    ok, buf = cv2.imencode(".png", arr)
    assert ok
    return buf.tobytes()


def _pil_png(img):
    b = io.BytesIO()
    img.save(b, format="PNG")
    return b.getvalue()


def _png_cases():
    rng = np.random.default_rng(0)
    h, w = 37, 53
    u8 = rng.integers(0, 256, (h, w, 3), np.uint8)
    u16 = rng.integers(0, 65536, (h, w, 3), np.uint16)
    return {
        "grey8": _cv2_png(u8[..., 0]),
        "rgb8": _cv2_png(u8),
        "rgba8": _cv2_png(np.dstack([u8, u8[..., :1]])),
        "palette8": _pil_png(Image.fromarray(u8).quantize(50)),
        "grey_alpha8": _pil_png(Image.fromarray(
            np.dstack([u8[..., 0], u8[..., 1]]), "LA")),
        "grey16": _cv2_png(u16[..., 0]),
        "rgb16": _cv2_png(u16),
        "rgba16": _cv2_png(np.dstack([u16, u16[..., :1]])),
    }


PNG_CASES = _png_cases()


def _decode_cv2(data, flag):
    return cv2.imdecode(np.frombuffer(data, np.uint8), flag)


@pytest.mark.parametrize("name", sorted(PNG_CASES))
def test_png_decode_is_cv2s_and_pils_bitwise(name, tmp_path):
    data = PNG_CASES[name]
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(data)
    want = cv2.cvtColor(_decode_cv2(data, cv2.IMREAD_COLOR),
                        cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(codec.imread_rgb(path), want)
    un = _decode_cv2(data, cv2.IMREAD_UNCHANGED)
    if un.ndim == 3:                        # BGR(A) -> RGB(A)
        un = un[..., [2, 1, 0, 3][:un.shape[2]]]
    got = codec.imread_unchanged(path)
    assert got.dtype == un.dtype and got.shape == un.shape
    np.testing.assert_array_equal(got, un)
    pil = Image.open(io.BytesIO(data))
    if pil.mode == "P":
        pil = pil.convert("RGB")
    if name not in ("rgb16", "rgba16"):     # PIL reads 16-bit colour as 8
        np.testing.assert_array_equal(
            np.asarray(pil).astype(np.int64),
            codec.decode_png(data)["pixels"].astype(np.int64))


@pytest.mark.parametrize("filter_type", [None, 0, 1, 2, 3, 4])
def test_png_write_read_round_trip_is_bitwise(filter_type, tmp_path):
    rng = np.random.default_rng(1)
    arrays = [rng.integers(0, 256, (23, 31, 3), np.uint8),
              rng.integers(0, 256, (23, 31), np.uint8),
              rng.integers(0, 65536, (23, 31), np.uint16),
              rng.integers(0, 256, (5, 7, 4), np.uint8)]
    for a in arrays:
        path = str(tmp_path / "r.png")
        codec.write_png(path, a, filter_type=filter_type)
        np.testing.assert_array_equal(codec.imread_unchanged(path), a)
        back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if a.ndim == 3:
            back = back[..., [2, 1, 0, 3][:a.shape[2]]]
        np.testing.assert_array_equal(back, a)


def test_png_refusals_name_themselves(tmp_path):
    """Adam7, bit depths below 8, a bad CRC; an unknown format is
    FileNotFoundError naming the file (ImageFolder's reader does the
    same)."""
    data = codec.encode_png(np.zeros((4, 4), np.uint8))
    ihdr = bytearray(data[16:29])

    def with_ihdr(body):
        crc = struct.pack(">I", zlib.crc32(b"IHDR" + bytes(body)))
        return data[:16] + bytes(body) + crc + data[33:]

    adam7 = bytearray(ihdr)
    adam7[12] = 1
    with pytest.raises(NotImplementedError, match="Adam7"):
        codec.decode_png(with_ihdr(adam7))
    low = bytearray(ihdr)
    low[8] = 4
    with pytest.raises(NotImplementedError, match="bit depth 4"):
        codec.decode_png(with_ihdr(low))
    bad = bytearray(data)
    bad[30] ^= 0xFF
    with pytest.raises(ValueError, match="CRC"):
        codec.decode_png(bytes(bad))
    p = tmp_path / "broken.png"
    p.write_bytes(b"not an image")
    with pytest.raises(FileNotFoundError, match="broken.png"):
        codec.imread_rgb(str(p))
    with pytest.raises(FileNotFoundError):
        codec.imread_rgb(str(tmp_path / "missing.png"))


def _jpeg_cases():
    rng = np.random.default_rng(2)
    cases = []
    for (h, w) in ((48, 64), (37, 53), (17, 3), (1, 1)):
        for q in (75, 95):
            img = _smooth(rng, max(h, 8), max(w, 8))[:h, :w].copy()
            for mode in MODES:
                for rst in (0, 2):
                    cases.append((f"{mode}_q{q}_{h}x{w}_rst{rst}", mode, img,
                                  [cv2.IMWRITE_JPEG_QUALITY, q,
                                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                   MODES[mode],
                                   cv2.IMWRITE_JPEG_RST_INTERVAL, rst]))
            grey = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
            cases.append((f"grey_q{q}_{h}x{w}", "grey", grey,
                          [cv2.IMWRITE_JPEG_QUALITY, q]))
    return cases


def test_jpeg_decode_is_within_the_limits_of_cv2():
    """All modes, qualities 75 / 95, restart markers every 2 MCUs, odd
    sizes, 1 x 1; grey files through IMREAD_COLOR come back replicated."""
    worst = {}
    for name, mode, img, params in _jpeg_cases():
        ok, buf = cv2.imencode(".jpg", img, params)
        assert ok
        want = _decode_cv2(buf.tobytes(), cv2.IMREAD_COLOR)
        got = codec.imdecode_rgb(buf.tobytes(), name)
        assert got.shape == want.shape, name
        err = int(np.abs(got.astype(int) - want[..., ::-1]).max())
        worst[mode] = max(worst.get(mode, 0), err)
        assert err <= LIMIT[mode], (name, err)
    assert sorted(worst) == sorted(LIMIT)


def test_committed_jpeg_fixtures_decode_to_their_saved_cv2_pixels():
    files = sorted(glob.glob(os.path.join(FIXTURES, "*.npy")))
    assert len(files) >= 6
    for npy in files:
        name = os.path.basename(npy)[:-4]
        want = np.load(npy)
        path = npy[:-4] + ".jpg"
        if want.ndim == 2:
            got = native.jpeg_decode(np.fromfile(path, np.uint8))
            mode = "grey"
        else:
            got = codec.imread_rgb(path)
            mode = name.split("_")[0]
        assert got.shape == want.shape, name
        assert int(np.abs(got.astype(int) - want).max()) <= LIMIT[mode], name
    strided = np.load(os.path.join(FIXTURES, "frames_cv2_stride13.npz"))
    frames = sorted(glob.glob(os.path.join(FIXTURES, "frame*.jpg")))
    assert sorted(strided) == ["frame0", "frame1"] and len(frames) == 2
    for frame in frames:
        want = cv2.cvtColor(cv2.imread(frame), cv2.COLOR_BGR2RGB)
        got = codec.imread_rgb(frame)
        assert got.shape == (480, 640, 3)
        assert int(np.abs(got.astype(int) - want).max()) <= LIMIT["420"]
        # the saved samples the card run holds its decode to are cv2's
        np.testing.assert_array_equal(
            strided[os.path.basename(frame).split("_")[0]], want[::13, ::13])


def _exif_app1(orientation: int) -> bytes:
    ifd = (struct.pack("<H", 1)
           + struct.pack("<HHII", 0x0112, 3, 1, orientation)
           + struct.pack("<I", 0))
    body = b"Exif\x00\x00" + b"II*\x00" + struct.pack("<I", 8) + ifd
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


@pytest.mark.parametrize("orientation", range(1, 9))
def test_jpeg_exif_orientation_is_applied_as_cv2_does(orientation):
    img = _smooth(np.random.default_rng(3), 21, 34)
    ok, buf = cv2.imencode(".jpg", img)
    data = buf.tobytes()
    data = data[:2] + _exif_app1(orientation) + data[2:]
    want = cv2.cvtColor(_decode_cv2(data, cv2.IMREAD_COLOR),
                        cv2.COLOR_BGR2RGB)
    got = codec.imdecode_rgb(data)
    assert got.shape == want.shape
    assert int(np.abs(got.astype(int) - want).max()) <= LIMIT["420"]


def _patched(data: bytes, marker: int, offset: int, value: int) -> bytes:
    """`data` with the byte at `offset` into the segment of `marker` set."""
    at = data.index(bytes([0xFF, marker]))
    out = bytearray(data)
    out[at + 4 + offset] = value
    return bytes(out)


def test_unsupported_jpeg_variants_raise_naming_themselves():
    img = _smooth(np.random.default_rng(4), 16, 16)
    ok, base = cv2.imencode(".jpg", img)
    base = base.tobytes()
    ok, prog = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(NotImplementedError, match="progressive"):
        codec.imdecode_rgb(prog.tobytes())
    sof = base.index(b"\xff\xc0")
    arith = base[:sof + 1] + b"\xc9" + base[sof + 2:]
    with pytest.raises(NotImplementedError, match="arithmetic"):
        codec.imdecode_rgb(arith)
    with pytest.raises(NotImplementedError, match="12-bit"):
        codec.imdecode_rgb(_patched(base, 0xC0, 0, 12))
    with pytest.raises(NotImplementedError, match="CMYK"):
        codec.imdecode_rgb(_patched(base, 0xC0, 5, 4))
    with pytest.raises(NotImplementedError, match="sampling"):
        codec.imdecode_rgb(_patched(base, 0xC0, 7, 0x41))
    lossless = base[:sof + 1] + b"\xc3" + base[sof + 2:]
    with pytest.raises(NotImplementedError, match="lossless"):
        codec.imdecode_rgb(lossless)
    with pytest.raises(ValueError, match="corrupt"):
        codec.imdecode_rgb(base[:len(base) // 2])
