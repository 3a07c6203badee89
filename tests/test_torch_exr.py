"""The port's EXR reader and writer (surs_tpu_torch/utils/exr.py, a copy
that imports nothing of the JAX package) against the JAX package's: the
writes are equal byte for byte, and a file written by either package
reads equal, bit for bit, in the other. Exactness is the tolerance: both
are the same numpy on the same bytes.
"""

import struct
import zlib

import numpy as np
import pytest

from surs_tpu.utils import exr as jexr
from surs_tpu_torch.utils import exr


def image(shape, seed=0, scale=3.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("half,compress", [(False, False), (False, True),
                                           (True, False), (True, True)])
@pytest.mark.parametrize("shape", [(37, 21, 3), (40, 8, 4), (17, 5),
                                   (1, 1, 3)])
def test_writes_equal_and_read_across(tmp_path, half, compress, shape):
    """Multi-block ZIP (16 lines a block, a partial tail), one channel,
    RGBA, a single pixel."""
    img = image(shape)
    ours, theirs = str(tmp_path / "port.exr"), str(tmp_path / "jax.exr")
    exr.write_exr(ours, img, half=half, compress=compress)
    jexr.write_exr(theirs, img, half=half, compress=compress)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    for path in (ours, theirs):
        got, want = exr.read_exr(path), jexr.read_exr(path)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    expect = img.astype(np.float16 if half else np.float32).astype(
        np.float32)
    np.testing.assert_array_equal(got, expect.reshape(got.shape))


def test_zip_block_stored_raw(tmp_path):
    """A block that zlib cannot shrink is stored raw and told by its
    size."""
    noise = np.random.default_rng(1).integers(0, 2 ** 32, (16, 64, 3),
                                              dtype=np.uint64)
    img = noise.astype(np.uint32).view(np.float32)
    img = np.where(np.isfinite(img), img, np.float32(1.5))
    p, q = str(tmp_path / "raw.exr"), str(tmp_path / "jax.exr")
    exr.write_exr(p, img, compress=True)
    jexr.write_exr(q, img, compress=True)
    buf = open(p, "rb").read()
    assert buf == open(q, "rb").read()
    # the one block, last in the file: its payload is the raw rows
    raw = img.nbytes
    assert struct.unpack_from("<iI", buf, len(buf) - raw - 8) == (0, raw)
    np.testing.assert_array_equal(exr.read_exr(p), jexr.read_exr(p))
    np.testing.assert_array_equal(exr.read_exr(p), img)


def handmade_exr(path, planes, names, ptype, compression):
    """A scanline EXR written here, independently of both writers:
    channels in ``names`` order (the file's chlist order), pixel type
    ``ptype`` (0 UINT, 1 HALF, 2 FLOAT), NO (0) or ZIPS (2) compression,
    one line a block."""
    H, W = planes[0].shape
    dt = {0: np.uint32, 1: np.float16, 2: np.float32}[ptype]

    def attr(name, typ, data):
        return (name.encode() + b"\0" + typ.encode() + b"\0"
                + struct.pack("<I", len(data)) + data)

    chl = b"".join(n.encode() + b"\0" + struct.pack("<i", ptype) + b"\0" * 4
                   + struct.pack("<ii", 1, 1) for n in names) + b"\0"
    box = struct.pack("<4i", 0, 0, W - 1, H - 1)
    header = (b"\x76\x2f\x31\x01" + struct.pack("<I", 2)
              + attr("channels", "chlist", chl)
              + attr("compression", "compression", bytes([compression]))
              + attr("dataWindow", "box2i", box)
              + attr("displayWindow", "box2i", box)
              + attr("lineOrder", "lineOrder", b"\0") + b"\0")
    chunks = []
    for y in range(H):
        rows = b"".join(p[y].astype(dt).tobytes() for p in planes)
        if compression == 2:
            # the OpenEXR byte transform: split even / odd bytes, then
            # deltas + 128, then zlib
            a = np.frombuffer(rows, np.uint8)
            d = np.concatenate([a[0::2], a[1::2]]).astype(np.int64)
            d[1:] = d[1:] - np.concatenate([a[0::2], a[1::2]])[:-1] + 128
            packed = zlib.compress((d & 0xFF).astype(np.uint8).tobytes())
            rows = packed if len(packed) < len(rows) else rows
        chunks.append(struct.pack("<iI", y, len(rows)) + rows)
    offsets, pos = [], len(header) + 8 * H
    for c in chunks:
        offsets.append(pos)
        pos += len(c)
    with open(path, "wb") as f:
        f.write(header + struct.pack(f"<{H}Q", *offsets) + b"".join(chunks))


@pytest.mark.parametrize("ptype", [0, 1, 2])
@pytest.mark.parametrize("compression", [0, 2])
def test_foreign_files_read_as_jax(tmp_path, ptype, compression):
    """Files from another writer: UINT / HALF / FLOAT channels stored
    B, G, R (reordered to R, G, B) or under other names (kept in file
    order), uncompressed or ZIPS."""
    rng = np.random.default_rng(2)
    planes = [rng.integers(0, 1000, (9, 64)).astype(np.float32)
              for _ in range(3)]
    for names in (["B", "G", "R"], ["X", "Y", "Z"]):
        p = str(tmp_path / f"{''.join(names)}.exr")
        handmade_exr(p, planes, names, ptype, compression)
        got = exr.read_exr(p)
        np.testing.assert_array_equal(got, jexr.read_exr(p))
        want = planes[::-1] if names[0] == "B" else planes
        np.testing.assert_array_equal(got, np.stack(want, -1))


def test_unsupported_files_raise_as_jax(tmp_path):
    p = str(tmp_path / "bad.exr")
    with open(p, "wb") as f:
        f.write(b"not an exr file")
    for mod in (exr, jexr):
        with pytest.raises(ValueError, match="not an EXR"):
            mod.read_exr(p)
    tiled = str(tmp_path / "tiled.exr")
    exr.write_exr(tiled, image((4, 4, 3)))
    buf = bytearray(open(tiled, "rb").read())
    buf[4:8] = struct.pack("<I", 2 | 0x200)
    open(tiled, "wb").write(bytes(buf))
    for mod in (exr, jexr):
        with pytest.raises(ValueError, match="tiled"):
            mod.read_exr(tiled)
