"""Image decoding without PIL: a PNG reader on the standard library
(``zlib`` + ``struct``) and the CLI's image loaders.

``read_png`` takes 8-bit grayscale, grayscale + alpha, RGB and RGBA,
non-interlaced, with any of the five row filters; anything else raises.
``load_rgb`` / ``load_gray`` decode through PIL where it is installed
(any format it reads) and through ``read_png`` where it is not; a file
other than PNG without PIL raises an error that names PIL.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (8-bit only)
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (PNG spec §9): filter byte + w * bpp
    bytes per row -> [h, w * bpp] uint8."""
    stride = w * bpp
    if len(raw) != h * (stride + 1):
        raise ValueError("PNG image data has the wrong length")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:                       # sub: a running sum
            cur = line.reshape(w, bpp).cumsum(0).reshape(-1) & 0xFF
        elif ftype == 2:                       # up
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):                  # average, paeth: serial
            cur = line.copy()
            for x in range(stride):
                a = int(cur[x - bpp]) if x >= bpp else 0
                if ftype == 3:
                    pred = (a + int(prev[x])) >> 1
                else:
                    c = int(prev[x - bpp]) if x >= bpp else 0
                    pred = _paeth(a, int(prev[x]), c)
                cur[x] = (cur[x] + pred) & 0xFF
        else:
            raise ValueError(f"PNG row filter {ftype} is not defined")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """An 8-bit, non-interlaced PNG -> [H, W, C] uint8 (C = 1 gray,
    2 gray + alpha, 3 RGB, 4 RGBA)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = len(_SIGNATURE), None, []
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: PNG of bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace}; without PIL only 8-bit gray, gray + "
            "alpha, RGB and RGBA, non-interlaced, are read")
    c = _CHANNELS[ctype]
    return _unfilter(zlib.decompress(b"".join(idat)), h, w, c).reshape(
        h, w, c)


def _pil_image():
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def _decode(path: str) -> np.ndarray:
    if not path.lower().endswith(".png"):
        raise RuntimeError(
            f"{path}: decoding this format needs PIL (Pillow), which is not "
            "installed; without it only PNG files are read")
    return read_png(path)


def load_rgb(path: str) -> np.ndarray:
    """[H, W, 3] uint8, as PIL's ``convert("RGB")``: gray replicated,
    alpha dropped."""
    Image = _pil_image()
    if Image is not None:
        return np.asarray(Image.open(path).convert("RGB"))
    img = _decode(path)
    return np.repeat(img[..., :1], 3, -1) if img.shape[-1] < 3 \
        else np.ascontiguousarray(img[..., :3])


def load_gray(path: str) -> np.ndarray:
    """[H, W] uint8, as PIL's ``convert("L")``: alpha dropped, RGB to
    luma with PIL's integer weights (ITU-R 601-2)."""
    Image = _pil_image()
    if Image is not None:
        return np.asarray(Image.open(path).convert("L"))
    img = _decode(path)
    if img.shape[-1] < 3:
        return np.ascontiguousarray(img[..., 0])
    rgb = img[..., :3].astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)
