"""PNG / JPEG reading and PNG writing without cv2 or PIL.

What cv2.imread, PIL and cv2.imwrite do for the JAX package's readers and
CLIs (mmde_tpu/data/datasets.py:32-43, void_v3.py:47-52 and :236,
void_pickle.py:202-203, tools/infer.py), for the card machine, which has
neither library. The format is told by the file's first bytes, as cv2
does, not by its name.

  * PNG: chunks and zlib here, the row unfiltering (types 0-4) in
    csrc/preprocess.cpp. Colour types 0, 2, 3, 4 and 6 at 8 bits, and 16
    bits for every type that allows them. Adam7 interlacing and bit depths
    below 8 raise NotImplementedError naming themselves.
  * JPEG: baseline / extended sequential Huffman, decoded in
    csrc/preprocess.cpp the way libjpeg-turbo does it by default (integer
    IDCT, fancy upsampling, fixed-point YCbCr), so the pixels are those of
    cv2.imread on this project's files (tests/test_torch_port_codec.py
    holds the limits). Progressive, arithmetic-coded, 12-bit and CMYK files
    raise NotImplementedError naming themselves.

`imread_rgb` is cv2.imread(IMREAD_COLOR) then BGR2RGB: grey replicated,
alpha dropped, 16-bit samples cut to their high byte, an EXIF orientation
applied. `imread_unchanged` is IMREAD_UNCHANGED for what the readers load
with it (16-bit depth as uint16, 8-bit grey as uint8); colour comes back in
RGB(A) order where cv2 gives BGR(A), and the orientation is not applied,
as cv2 does not apply it there. `write_png` writes 8- or 16-bit grey, RGB
or RGBA with libpng's adaptive row filters.
"""
from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

from mmde_tpu_torch.data import native

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
JPEG_MAGIC = b"\xff\xd8\xff"
# samples per pixel of each PNG colour type
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _read(path: str) -> bytes:
    try:
        with open(path, "rb") as f:
            return f.read()
    except (FileNotFoundError, IsADirectoryError) as e:
        raise FileNotFoundError(path) from e


# ------------------------------------------------------------------ PNG --

def _png_chunks(data: bytes, what: str):
    pos = len(PNG_MAGIC)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n or pos + 12 + n > len(data):
            raise ValueError(f"{what}: truncated PNG chunk {kind!r}")
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{what}: PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{what}: PNG without IEND")


def decode_png(data: bytes, what: str = "PNG") -> dict:
    """The PNG's samples as stored: {"pixels": (H, W) or (H, W, C) uint8 /
    uint16 (palette expanded to RGB), "orientation" (from an eXIf chunk, 1
    without)}."""
    hdr, palette, idat, orientation = None, None, [], 1
    for kind, body in _png_chunks(data, what):
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"eXIf":
            orientation = exif_orientation(body)
    if hdr is None or not idat:
        raise ValueError(f"{what}: PNG without IHDR or IDAT")
    w, h, depth, ctype, _, _, interlace = hdr
    if interlace:
        raise NotImplementedError(
            f"{what}: Adam7-interlaced PNG is not supported")
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f"{what}: PNG colour type {ctype}")
    if depth not in (8, 16) or (ctype == 3 and depth != 8):
        raise NotImplementedError(
            f"{what}: PNG bit depth {depth} (colour type {ctype}) is not "
            f"supported (8, and 16 where the type allows it)")
    ch = _PNG_CHANNELS[ctype]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = native.png_unfilter(raw, h, w * bpp, bpp)
    if depth == 16:
        px = rows.view(">u2").astype(np.uint16)
    else:
        px = rows
    px = px.reshape(h, w, ch)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{what}: palette PNG without PLTE")
        idx = px[..., 0]
        if int(idx.max(initial=0)) >= len(palette):
            raise ValueError(f"{what}: palette index out of range")
        px = palette[idx]
    elif ch == 1:
        px = px[..., 0]
    return {"pixels": np.ascontiguousarray(px), "orientation": orientation}


def encode_png(img: np.ndarray, filter_type: Optional[int] = None) -> bytes:
    """PNG bytes of `img`: uint8 or uint16, (H, W) grey, (H, W, 3) RGB or
    (H, W, 4) RGBA. `filter_type` 0-4 filters every row the same way; None
    picks each row's filter as libpng does (least sum of the filtered bytes
    read as signed)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write_png takes uint8 or uint16, got {img.dtype}")
    if img.ndim == 2:
        ctype, ch = 0, 1
    elif img.ndim == 3 and img.shape[2] in (3, 4):
        ctype, ch = (2, 3) if img.shape[2] == 3 else (6, 4)
    else:
        raise ValueError(f"write_png takes (H, W), (H, W, 3) or (H, W, 4), "
                         f"got {img.shape}")
    h, w = img.shape[:2]
    depth = 16 if img.dtype == np.uint16 else 8
    bpp = ch * depth // 8
    cur = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img
                               ).view(np.uint8).reshape(h, w * bpp)
    cur = cur.astype(np.int16)
    prev = np.zeros_like(cur)
    prev[1:] = cur[:-1]
    left = np.zeros_like(cur)
    left[:, bpp:] = cur[:, :-bpp]

    def filtered(t: int) -> np.ndarray:
        if t == 0:
            return cur
        if t == 1:
            return cur - left
        if t == 2:
            return cur - prev
        if t == 3:
            return cur - ((left + prev) >> 1)
        upleft = np.zeros_like(cur)
        upleft[:, bpp:] = prev[:, :-bpp]
        p = left + prev - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
        return cur - np.where((pa <= pb) & (pa <= pc), left,
                              np.where(pb <= pc, prev, upleft))

    if filter_type is None:
        cands = np.stack([filtered(t) for t in range(5)]) & 0xFF
        signed = np.where(cands >= 128, 256 - cands, cands)
        choice = signed.sum(axis=2).argmin(axis=0)
        rows = cands[choice, np.arange(h)].astype(np.uint8)
    else:
        if filter_type not in range(5):
            raise ValueError(f"PNG filter type {filter_type}")
        choice = np.full(h, filter_type)
        rows = (filtered(filter_type) & 0xFF).astype(np.uint8)
    raw = np.concatenate([choice.astype(np.uint8)[:, None], rows], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    return (PNG_MAGIC + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray,
              filter_type: Optional[int] = None) -> None:
    """Write `img` to `path` as PNG (see encode_png; zlib level 6, libpng's
    default)."""
    data = encode_png(img, filter_type)
    with open(path, "wb") as f:
        f.write(data)


# ----------------------------------------------------------------- JPEG --

def _jpeg_exif(data: bytes) -> Optional[bytes]:
    """The TIFF body of a JPEG's APP1 Exif segment, if any (markers before
    the first scan)."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        if marker in (0xDA, 0xD9):
            return None
        n, = struct.unpack(">H", data[pos + 2:pos + 4])
        body = data[pos + 4:pos + 2 + n]
        if marker == 0xE1 and body[:6] == b"Exif\x00\x00":
            return body[6:]
        pos += 2 + n
    return None


def exif_orientation(tiff: bytes) -> int:
    """The Orientation tag (0x0112) of IFD0 of an Exif TIFF body; 1 when it
    is absent or unreadable."""
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if tiff[:2] == b"II" else ">"
    ifd, = struct.unpack(e + "I", tiff[4:8])
    if ifd + 2 > len(tiff):
        return 1
    n, = struct.unpack(e + "H", tiff[ifd:ifd + 2])
    for i in range(n):
        at = ifd + 2 + 12 * i
        if at + 12 > len(tiff):
            return 1
        tag, typ = struct.unpack(e + "HH", tiff[at:at + 4])
        if tag == 0x0112 and typ == 3:
            value, = struct.unpack(e + "H", tiff[at + 8:at + 10])
            return value if 1 <= value <= 8 else 1
    return 1


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """cv2's ExifTransform: the EXIF orientation's flips and transposes."""
    if orientation == 1:
        return img
    t = (1, 0) + tuple(range(2, img.ndim))
    ops = {2: lambda a: a[:, ::-1],
           3: lambda a: a[::-1, ::-1],
           4: lambda a: a[::-1],
           5: lambda a: a.transpose(t),
           6: lambda a: a.transpose(t)[:, ::-1],
           7: lambda a: a.transpose(t)[::-1, ::-1],
           8: lambda a: a.transpose(t)[::-1]}
    return np.ascontiguousarray(ops[orientation](img))


# ------------------------------------------------------------- readers --

def _decode(data: bytes, what: str) -> dict:
    if data[:8] == PNG_MAGIC:
        return decode_png(data, what)
    if data[:3] == JPEG_MAGIC:
        px = native.jpeg_decode(np.frombuffer(data, np.uint8), what)
        exif = _jpeg_exif(data)
        return {"pixels": px,
                "orientation": exif_orientation(exif) if exif else 1}
    raise FileNotFoundError(f"{what}: not a PNG or JPEG file")


def imdecode_rgb(data: bytes, what: str = "image") -> np.ndarray:
    """(H, W, 3) uint8 RGB of PNG or JPEG bytes, as cv2.imdecode with
    IMREAD_COLOR then BGR2RGB gives it."""
    d = _decode(data, what)
    px = d["pixels"]
    if px.dtype == np.uint16:
        px = (px >> 8).astype(np.uint8)
    if px.ndim == 2:
        px = np.repeat(px[..., None], 3, axis=2)
    elif px.shape[2] == 2:                  # grey + alpha
        px = np.repeat(px[..., :1], 3, axis=2)
    elif px.shape[2] == 4:
        px = px[..., :3]
    return apply_orientation(np.ascontiguousarray(px), d["orientation"])


def imread_rgb(path: str) -> np.ndarray:
    """cv2.imread(path) then BGR2RGB: (H, W, 3) uint8. FileNotFoundError
    for a missing file or one that is neither PNG nor JPEG."""
    return imdecode_rgb(_read(path), path)


def imread_unchanged(path: str) -> np.ndarray:
    """The file's samples at their own depth (cv2's IMREAD_UNCHANGED):
    (H, W) for grey, (H, W, C) otherwise, channels in RGB(A) order; uint16
    for 16-bit PNG; grey + alpha becomes RGBA, as in cv2. No orientation is
    applied."""
    px = _decode(_read(path), path)["pixels"]
    if px.ndim == 3 and px.shape[2] == 2:
        px = np.ascontiguousarray(px[..., [0, 0, 0, 1]])
    return px
