"""Minimal OpenEXR scanline reader and writer in numpy (the port's copy
of ``surs_tpu/utils/exr.py``; the port imports nothing of the JAX
package).

The color branch reads per-texel 3-D surface positions from
``UV_POS/<subject>/00.exr`` (``data/datasets.py:get_color_sampling``) and
writes them in ``render/uv.py``; neither OpenCV nor the OpenEXR bindings
are needed. Supported, as the THuman assets use them:

  * single-part scanline images, increasing line order;
  * NO / ZIPS / ZIP compression (ZIP blocks are zlib plus the OpenEXR
    byte transform: delta reconstruction, then the two halves
    interleaved, ImfZip.cpp's semantics; a chunk stored raw because
    compression did not shrink it is told by its size);
  * HALF / FLOAT / UINT channels, no subsampling.

``read_exr`` returns [H, W, C] float32 with the channels in R, G, B(, A)
order when their names allow. ``write_exr`` writes uncompressed or ZIP
scanline files, byte for byte as the JAX package's writer.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

_MAGIC = b"\x76\x2f\x31\x01"
_PT_DTYPE = {0: np.uint32, 1: np.float16, 2: np.float32}
_PT_SIZE = {0: 4, 1: 2, 2: 4}
_BLOCK_LINES = {0: 1, 2: 1, 3: 16}      # NO, ZIPS, ZIP


def _read_cstr(buf: bytes, off: int) -> Tuple[str, int]:
    end = buf.index(b"\x00", off)
    return buf[off:end].decode("latin-1"), end + 1


def _unzip(data: bytes, expected: int) -> bytes:
    if len(data) == expected:       # stored raw (didn't compress)
        return data
    raw = zlib.decompress(data)
    # reconstruct (delta decode): out[0] = raw[0];
    # out[i] = out[i-1] + raw[i] - 128  (mod 256) — ImfZip.cpp
    arr = np.frombuffer(raw, np.uint8).astype(np.int64)
    arr[1:] -= 128
    rec = (np.cumsum(arr) & 0xFF).astype(np.uint8)
    # ... then interleave the two halves
    n = rec.shape[0]
    out = np.empty(n, np.uint8)
    h = (n + 1) // 2
    out[0::2] = rec[:h]
    out[1::2] = rec[h:]
    return out.tobytes()


def _zip(data: bytes) -> bytes:
    arr = np.frombuffer(data, np.uint8)
    n = arr.shape[0]
    h = (n + 1) // 2
    deint = np.empty(n, np.uint8)
    deint[:h] = arr[0::2]
    deint[h:] = arr[1::2]
    d = deint.astype(np.int64)
    d[1:] = d[1:] - d[:-1] + 128
    packed = zlib.compress((d & 0xFF).astype(np.uint8).tobytes(), 6)
    return packed if len(packed) < n else data


def read_exr(path: str) -> np.ndarray:
    """Read a scanline EXR -> [H, W, C] float32 (R, G, B(, A) order
    when channel names allow, else alphabetical chlist order)."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:4] != _MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    version = struct.unpack_from("<I", buf, 4)[0]
    if version & 0x200:
        raise ValueError(f"{path}: tiled EXR not supported")
    off = 8
    channels: List[Tuple[str, int]] = []
    compression = None
    dw = None
    while True:
        if buf[off] == 0:
            off += 1
            break
        name, off = _read_cstr(buf, off)
        _type, off = _read_cstr(buf, off)
        size = struct.unpack_from("<I", buf, off)[0]
        off += 4
        data = buf[off:off + size]
        off += size
        if name == "channels":
            c_off = 0
            while data[c_off] != 0:
                cname, c_off = _read_cstr(data, c_off)
                ptype = struct.unpack_from("<i", data, c_off)[0]
                xs, ys = struct.unpack_from("<ii", data, c_off + 8)
                if (xs, ys) != (1, 1):
                    raise ValueError(f"{path}: subsampled channels "
                                     f"not supported")
                channels.append((cname, ptype))
                c_off += 16
        elif name == "compression":
            compression = data[0]
        elif name == "dataWindow":
            dw = struct.unpack("<4i", data)
    if compression not in _BLOCK_LINES:
        raise ValueError(f"{path}: compression {compression} not "
                         f"supported (NO/ZIPS/ZIP only)")
    x_min, y_min, x_max, y_max = dw
    W = x_max - x_min + 1
    H = y_max - y_min + 1
    lines_per = _BLOCK_LINES[compression]
    n_blocks = (H + lines_per - 1) // lines_per
    offsets = struct.unpack_from(f"<{n_blocks}Q", buf, off)

    line_bytes = sum(W * _PT_SIZE[pt] for _, pt in channels)
    out = {cname: np.empty((H, W), np.float32) for cname, _ in channels}
    for bi, boff in enumerate(offsets):
        y, size = struct.unpack_from("<iI", buf, boff)
        data = buf[boff + 8:boff + 8 + size]
        ln = min(lines_per, y_max - y + 1)
        if compression != 0:
            data = _unzip(data, ln * line_bytes)
        pos = 0
        for li in range(ln):
            row = y - y_min + li
            for cname, pt in channels:
                nb = W * _PT_SIZE[pt]
                vals = np.frombuffer(data, _PT_DTYPE[pt], W, pos)
                out[cname][row] = vals.astype(np.float32)
                pos += nb
    names = [c for c, _ in channels]
    if set(names) >= {"R", "G", "B"}:
        order = ["R", "G", "B"] + (["A"] if "A" in names else [])
    else:
        order = names
    return np.stack([out[c] for c in order], axis=-1)


def write_exr(path: str, img: np.ndarray, half: bool = False,
              compress: bool = True) -> None:
    """Write [H, W, C<=4] float as a scanline EXR (channels named
    R, G, B, A; ZIP or uncompressed)."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    names = ["R", "G", "B", "A"][:C]
    ptype = 1 if half else 2
    dt = np.float16 if half else np.float32
    comp = 3 if compress else 0          # ZIP / NO
    lines_per = _BLOCK_LINES[comp]

    def attr(name, typ, data):
        return (name.encode() + b"\x00" + typ.encode() + b"\x00"
                + struct.pack("<I", len(data)) + data)

    chl = b""
    for n in sorted(names):
        chl += (n.encode() + b"\x00" + struct.pack("<i", ptype)
                + b"\x00\x00\x00\x00" + struct.pack("<ii", 1, 1))
    chl += b"\x00"
    header = _MAGIC + struct.pack("<I", 2)
    header += attr("channels", "chlist", chl)
    header += attr("compression", "compression", bytes([comp]))
    box = struct.pack("<4i", 0, 0, W - 1, H - 1)
    header += attr("dataWindow", "box2i", box)
    header += attr("displayWindow", "box2i", box)
    header += attr("lineOrder", "lineOrder", b"\x00")
    header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
    header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\x00"

    n_blocks = (H + lines_per - 1) // lines_per
    chunks = []
    for bi in range(n_blocks):
        y0 = bi * lines_per
        ln = min(lines_per, H - y0)
        rows = b""
        for li in range(ln):
            for n in sorted(names):
                rows += img[y0 + li, :, names.index(n)].astype(
                    dt).tobytes()
        payload = _zip(rows) if comp else rows
        chunks.append(struct.pack("<iI", y0, len(payload)) + payload)

    table_off = len(header) + 8 * n_blocks
    offsets = []
    pos = table_off
    for ch in chunks:
        offsets.append(pos)
        pos += len(ch)
    with open(path, "wb") as f:
        f.write(header)
        f.write(struct.pack(f"<{n_blocks}Q", *offsets))
        for ch in chunks:
            f.write(ch)
