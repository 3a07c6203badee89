"""The port's CLI (``python -m surs_tpu_torch``) and its PNG reader
(surs_tpu_torch/data/png.py), which stands in for PIL where PIL is not
installed: seeded PNGs of every colour type it takes, written with all
five row filters, decode to the same pixels through it and through PIL;
and ``main()`` serves one image pair on the CPU at a tiny size with PIL
hidden."""

import struct
import sys
import zlib

import numpy as np
import pytest
import torch

from surs_tpu_torch.__main__ import main
from surs_tpu_torch.data import png

torch.set_num_threads(1)
# PNG colour type -> channels
MODES = {0: 1, 4: 2, 2: 3, 6: 4}


def _filter_row(ftype, line, prev, bpp):
    """PNG's forward row filter ``ftype`` (spec §9) of one row."""
    line, prev = line.astype(np.int32), prev.astype(np.int32)
    left = np.concatenate([np.zeros(bpp, np.int32), line[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
    if ftype == 0:
        pred = np.zeros_like(line)
    elif ftype == 1:
        pred = left
    elif ftype == 2:
        pred = prev
    elif ftype == 3:
        pred = (left + prev) >> 1
    else:
        pred = np.array([png._paeth(int(a), int(b), int(c))
                         for a, b, c in zip(left, prev, upleft)], np.int32)
    return ((line - pred) & 0xFF).astype(np.uint8)


def write_png(path, img, ctype):
    """[H, W, C] uint8 -> an 8-bit PNG whose rows cycle through the
    filters 0-4."""
    h, w, c = img.shape
    rows, prev = [], np.zeros(w * c, np.uint8)
    for y in range(h):
        line = img[y].reshape(-1)
        rows.append(bytes([y % 5]) + _filter_row(y % 5, line, prev,
                                                 c).tobytes())
        prev = line

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(png._SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(b"".join(rows)))
                + chunk(b"IEND", b""))


def seeded_image(c, seed=0, h=13, w=11):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c),
                                                dtype=np.uint8)


@pytest.fixture
def no_pil(monkeypatch):
    """Make ``from PIL import Image`` fail, as on a machine without PIL."""
    monkeypatch.setitem(sys.modules, "PIL", None)


@pytest.mark.parametrize("ctype", sorted(MODES))
def test_read_png_matches_pil(tmp_path, ctype):
    from PIL import Image
    img = seeded_image(MODES[ctype], seed=ctype)
    path = str(tmp_path / "a.png")
    write_png(path, img, ctype)
    got = png.read_png(path)
    np.testing.assert_array_equal(got, img)
    want = np.asarray(Image.open(path))
    np.testing.assert_array_equal(got.reshape(want.shape), want)


@pytest.mark.parametrize("ctype", sorted(MODES))
def test_loaders_without_pil_match_pil(tmp_path, monkeypatch, ctype):
    """load_rgb / load_gray give PIL's convert("RGB") / convert("L")."""
    img = seeded_image(MODES[ctype], seed=10 + ctype)
    path = str(tmp_path / "a.png")
    write_png(path, img, ctype)
    with_pil = png.load_rgb(path), png.load_gray(path)
    monkeypatch.setitem(sys.modules, "PIL", None)
    without = png.load_rgb(path), png.load_gray(path)
    for a, b in zip(without, with_pil):
        assert a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


def test_other_formats_without_pil_name_pil(tmp_path, no_pil):
    path = tmp_path / "a.jpg"
    path.write_bytes(b"\xff\xd8\xff")
    with pytest.raises(RuntimeError, match="PIL"):
        png.load_rgb(str(path))


def test_read_png_rejects_what_it_does_not_take(tmp_path):
    path = str(tmp_path / "a.png")
    write_png(path, seeded_image(3), 2)
    data = bytearray(open(path, "rb").read())
    data[24] = 16                                   # IHDR bit depth
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="bit depth 16"):
        png.read_png(path)


def test_main_serves_a_png_pair_on_the_cpu_without_pil(tmp_path, no_pil):
    """``main(--once --device cpu)`` at a tiny size: one image and its
    mask in, the HR / LR OBJ pair out."""
    S = 16
    yy, xx = np.mgrid[:S, :S]
    img = (np.random.default_rng(0).random((S, S, 3)) * 255).astype(np.uint8)
    mask = ((((xx - 8) / 4.8) ** 2 + ((yy - 8) / 6.7) ** 2) < 1
            ).astype(np.uint8) * 255
    watch = tmp_path / "in"
    watch.mkdir()
    write_png(str(watch / "subj.png"), img, 2)
    write_png(str(watch / "subj_mask.png"), mask[..., None], 0)
    out = tmp_path / "out"
    main(["--watch_dir", str(watch), "--once", "--device", "cpu",
          "--loadSize", "32", "--num_stack_lr", "1", "--resolution", "32",
          "--octree_init_resolution", "8", "--seed", "2",
          "--b_min", "-0.5", "-0.5", "-0.5", "--b_max", "0.5", "0.5", "0.5",
          "--results_path", str(out), "--name", "cli"])
    for suffix in ("_HR.obj", "_LR.obj"):
        text = (out / "cli" / f"subj{suffix}").read_text()
        assert text.startswith("v ") and "\nf " in text
