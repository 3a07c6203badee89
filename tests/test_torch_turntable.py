"""The port's turntable (surs_tpu_torch/render/turntable.py and the
render_turntable app) against the JAX package's
(surs_tpu/render/turntable.py, apps/render_turntable.py) on the CPU.

Tolerances: the frames as tests/test_torch_render.py's views (RGB within
1 LSB on 99.9 % of the pixels); the GIF of the same frames the same
bytes; the apps' GIFs decode to frames under the frames' rule.
"""

import os
import runpy
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from surs_tpu.recon.mesh_io import save_obj_mesh as jax_save_obj
from surs_tpu.render import turntable as jax_turntable
from surs_tpu_torch.apps import render_turntable as turntable_cli
from surs_tpu_torch.render import turntable
from tests.test_torch_render import RGB_SHARE, humanoid

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES, RES = 6, 32


@pytest.fixture(scope="module")
def mesh():
    return humanoid(24)


def assert_frames_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (RES, RES, 3) and g.dtype == np.uint8
        close = (np.abs(g.astype(int) - w.astype(int)) <= 1).all(-1)
        assert close.mean() >= RGB_SHARE


def gif_frames(path):
    im = Image.open(path)
    out = []
    for i in range(im.n_frames):
        im.seek(i)
        out.append(np.asarray(im.convert("RGB")))
    return out


def test_turntable_frames_and_gif_match_jax(mesh, tmp_path):
    v, f = mesh
    got = turntable.turntable_frames(v, f, FRAMES, RES, device="cpu")
    want = jax_turntable.turntable_frames(v, f, FRAMES, RES)
    assert_frames_close(got, want)
    assert any(g.any() for g in got)
    # the same frames give the same file
    turntable.save_gif(want, str(tmp_path / "port.gif"))
    jax_turntable.save_gif(want, str(tmp_path / "jax.gif"))
    assert (tmp_path / "port.gif").read_bytes() == \
        (tmp_path / "jax.gif").read_bytes()


def test_render_turntable_app_matches_jax(mesh, tmp_path, monkeypatch,
                                          capsys):
    v, f = mesh
    obj = str(tmp_path / "mesh_HR.obj")
    jax_save_obj(obj, v, f)
    port_gif, jax_gif = str(tmp_path / "port.gif"), str(tmp_path / "j.gif")
    flags = ["--frames", str(FRAMES), "--res", str(RES)]
    turntable_cli.main([obj, port_gif, "--device", "cpu"] + flags)
    assert capsys.readouterr().out.strip() == f"saved {port_gif}"
    monkeypatch.setattr(sys, "argv", ["render_turntable.py", obj, jax_gif]
                        + flags)
    runpy.run_path(os.path.join(ROOT, "apps", "render_turntable.py"),
                   run_name="__main__")
    assert_frames_close(gif_frames(port_gif), gif_frames(jax_gif))


def test_turntable_without_pil_names_it(mesh, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="PIL"):
        turntable.save_gif([np.zeros((4, 4, 3), np.uint8)],
                           str(tmp_path / "x.gif"))
