"""The color branch's data path in the port (surs_tpu_torch/render/uv.py,
render_dataset --uv, TrainDataset.get_color_sampling) against the JAX
package on the CPU.

Tolerances:
  * the atlas and its patch: equal;
  * UV maps of the same mesh (the rasterizers' tests' rule,
    tests/test_torch_render.py): masks equal on 99.9 % of the texels;
    where both are set, positions and albedo within 1e-5 and unit
    normals within 1e-4 (float32 interpolation in another order, a
    vertex normal's sum in another order);
  * written layouts: the same files; UV_POS within 1e-5, UV_MASK equal
    on 99.9 %, UV_NORMAL and the UV_RENDER JPEGs within 1 LSB on 99.9 %
    of the texels;
  * items read from one layout with one rng: equal, key for key.
"""

import os
import runpy
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from surs_tpu.config import SuRSConfig as JConfig
from surs_tpu.data.datasets import TrainDataset as JTrainDataset
from surs_tpu.recon.mesh_io import save_obj_mesh_with_color as j_save_color
from surs_tpu.render import uv as juv
from surs_tpu.utils.exr import read_exr as j_read_exr
from surs_tpu_torch.apps import render_dataset as render_cli
from surs_tpu_torch.config import SuRSConfig
from surs_tpu_torch.data.datasets import TrainDataset
from surs_tpu_torch.recon.tetra import marching_tetrahedra
from surs_tpu_torch.render import uv
from surs_tpu_torch.utils.exr import read_exr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MASK_SHARE = 0.999
YAWS = [0, 180]
S = 32


def blob(R=14, radius=5.0, scale=1.0 / 10):
    """A bumpy closed mesh with position-coded vertex colors."""
    g = np.mgrid[:R, :R, :R].astype(np.float64) - (R - 1) / 2
    r = np.sqrt((g ** 2).sum(0))
    vol = (radius + 0.8 * np.sin(g[0]) * np.cos(g[1]) - r).astype(np.float32)
    v, f = (a.numpy() for a in marching_tetrahedra(torch.from_numpy(vol),
                                                     0.0))
    v = ((v - (R - 1) / 2) * scale).astype(np.float32)
    colors = np.clip(v / (2 * np.abs(v).max()) + 0.5, 0, 1)
    return v, np.asarray(f, np.int64), colors.astype(np.float32)


@pytest.mark.parametrize("n_faces,uv_size", [(12, 64), (1000, 512),
                                             (327_680, 512)])
def test_atlas_and_patch_equal(n_faces, uv_size):
    np.testing.assert_array_equal(uv.triangle_atlas_uvs(n_faces),
                                  juv.triangle_atlas_uvs(n_faces))
    assert uv._atlas_patch(n_faces, uv_size) == juv._atlas_patch(n_faces,
                                                                 uv_size)
    if n_faces == 327_680:
        assert uv._atlas_patch(n_faces, uv_size) == 16


def assert_maps_close(got, want):
    (pg, ng, ag, mg), (pw, nw, aw, mw) = got, want
    assert mg.dtype == mw.dtype == np.bool_
    assert (mg == mw).mean() >= MASK_SHARE
    both = mg & mw
    assert both.sum() > 100
    np.testing.assert_allclose(pg[both], pw[both], rtol=0, atol=1e-5)
    np.testing.assert_allclose(ag[both], aw[both], rtol=0, atol=1e-5)
    np.testing.assert_allclose(ng[both], nw[both], rtol=0, atol=1e-4)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == np.float32 and g.shape == w.shape


@pytest.mark.parametrize("colored", [True, False])
def test_render_uv_maps_matches_jax(colored):
    v, f, c = blob()
    kw = dict(colors=c if colored else None, uv_size=64)
    got = uv.render_uv_maps(v, f, device="cpu", **kw)
    want = tuple(np.asarray(a) for a in juv.render_uv_maps(v, f, **kw))
    assert_maps_close(got, want)
    pos, nrm, albedo, mask = got
    # a texel's albedo is its position's code: one surface point a texel
    if colored:
        np.testing.assert_allclose(
            albedo[mask], np.clip(pos[mask] / (2 * np.abs(v).max()) + 0.5,
                                  0, 1), atol=1e-5)
    else:
        np.testing.assert_allclose(albedo[mask], 0.75, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(nrm[mask], axis=1), 1.0,
                               atol=1e-5)


def test_render_uv_maps_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    v, f, _ = blob()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        uv.render_uv_maps(v, f, uv_size=16)


def write_subjects(obj_dir, names=("a", "b")):
    os.makedirs(obj_dir)
    for i, name in enumerate(names):
        v, f, c = blob(radius=5.0 - i * 0.5)
        j_save_color(os.path.join(obj_dir, f"{name}_HR.obj"), v, f, c)


def tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def assert_same_uv_layout(got_root, want_root):
    files = [r for r in tree(want_root) if r.startswith("UV_")]
    assert [r for r in tree(got_root) if r.startswith("UV_")] == files
    for rel in files:
        g, w = (os.path.join(r, rel) for r in (got_root, want_root))
        if rel.endswith(".exr"):
            gp, wp = read_exr(g), j_read_exr(w)
            assert gp.shape == wp.shape
            np.testing.assert_allclose(gp, wp, rtol=0, atol=1e-5)
            continue
        gi = np.asarray(Image.open(g)).astype(int)
        wi = np.asarray(Image.open(w)).astype(int)
        assert gi.shape == wi.shape
        close = np.abs(gi - wi) <= (0 if "UV_MASK" in rel else 1)
        if close.ndim == 3:
            close = close.all(-1)
        assert close.mean() >= MASK_SHARE, rel


def test_render_uv_dataset_matches_jax(tmp_path):
    obj_dir = str(tmp_path / "GEO" / "OBJ")
    write_subjects(obj_dir)
    got, want = str(tmp_path / "port"), str(tmp_path / "jax")
    uv.render_uv_dataset(obj_dir, got, uv_size=48, yaw_step=120,
                         device="cpu")
    juv.render_uv_dataset(obj_dir, want, uv_size=48, yaw_step=120)
    assert tree(got)[:3] == ["UV_MASK/a/00.png", "UV_MASK/b/00.png",
                             "UV_NORMAL/a/00.png"]
    assert len(tree(got)) == 2 * (3 + 3)
    assert_same_uv_layout(got, want)


def test_render_dataset_cli_uv_matches_jax(tmp_path, monkeypatch):
    """``python -m surs_tpu_torch.apps.render_dataset --uv`` against
    ``apps/render_dataset.py --uv``: the views and the UV layout."""
    from test_torch_render import assert_same_dataset
    roots = [tmp_path / "port", tmp_path / "jax"]
    for r in roots:
        write_subjects(str(r / "GEO" / "OBJ"), names=("b",))
    flags = ["--loadSize", "32", "--yaw_step", "180", "--uv",
             "--uv_size", "32"]
    render_cli.main(["--dataroot", str(roots[0]), "--device", "cpu"]
                    + flags)
    monkeypatch.setattr(sys, "argv", ["render_dataset.py", "--dataroot",
                                      str(roots[1])] + flags)
    runpy.run_path(os.path.join(ROOT, "apps", "render_dataset.py"),
                   run_name="__main__")
    assert [r for r in tree(str(roots[0])) if r.startswith("UV_")] == [
        "UV_MASK/b/00.png", "UV_NORMAL/b/00.png", "UV_POS/b/00.exr",
        "UV_RENDER/b/0_0_00.jpg", "UV_RENDER/b/180_0_00.jpg"]
    assert_same_uv_layout(str(roots[0]), str(roots[1]))
    for sub in ("RENDER", "MASK", "PARAM"):
        assert_same_dataset(str(roots[0] / sub), str(roots[1] / sub))


# -------------------------------------------------------- TrainDataset ---
@pytest.fixture(scope="module")
def color_root(tmp_path_factory):
    """test_torch_dataset.py's two-sphere dataset at 32, with the UV
    layout at 32 rendered by the port and a sample cache of one draw a
    subject."""
    from test_torch_dataset import render_tiny_dataset
    root = str(tmp_path_factory.mktemp("color_data"))
    render_tiny_dataset(root)
    uv.render_uv_dataset(os.path.join(root, "GEO", "OBJ"), root, uv_size=32,
                         yaw_step=180, device="cpu")
    cache = os.path.join(root, "cache")
    os.makedirs(cache)
    rng = np.random.default_rng(0)
    for name in ("subj0", "subj1"):
        np.savez(os.path.join(cache, f"{name}_0.npz"),
                 samples_HR=rng.random((3, 32), np.float32),
                 samples_LR=rng.random((3, 32), np.float32),
                 labels_HR=rng.random((1, 32), np.float32),
                 labels_disp=rng.random((1, 32), np.float32))
    return root


def color_configs(root, **kw):
    base = dict(dataroot=root, loadSize=S, num_sample_inout=32, sigma=0.05,
                b_min=[-1.0] * 3, b_max=[1.0] * 3, seed=7,
                num_sample_color=40, random_flip=True, aug_bri=0.3)
    base.update(kw)
    return JConfig(**base), SuRSConfig(**base)


@pytest.mark.parametrize("phase,cached", [("train", False), ("test", False),
                                          ("train", True)])
def test_train_dataset_color_items_match_jax(color_root, phase, cached):
    """Occupancy samples (fresh or from the cache), then the color
    samples from the same rng: the JAX item key for key."""
    from test_torch_dataset import assert_items_equal
    jcfg, pcfg = color_configs(color_root)
    cache = os.path.join(color_root, "cache") if cached else None
    want_ds = JTrainDataset(jcfg, phase, yaw_list=YAWS,
                            sample_cache_dir=cache)
    got_ds = TrainDataset(pcfg, phase, yaw_list=YAWS, sample_cache_dir=cache,
                          contains_device="cpu")
    assert got_ds.has_uv_renders() and want_ds.has_uv_renders()
    for i in range(len(got_ds)):
        want = want_ds.get_item(i, np.random.default_rng(50 + i))
        got = got_ds.get_item(i, np.random.default_rng(50 + i))
        assert_items_equal(got, want)
        assert got["color_samples"].shape == got["rgbs"].shape == (3, 40)
        assert np.abs(got["rgbs"]).max() <= 1.0


@pytest.mark.parametrize("n", [0, 10_000])
def test_get_color_sampling_matches_jax(color_root, n):
    """Every masked texel (n = 0), and more samples than texels (drawn
    with replacement)."""
    jcfg, pcfg = color_configs(color_root, num_sample_color=n)
    want = JTrainDataset(jcfg, yaw_list=YAWS).get_color_sampling(
        "subj1", 1, rng=np.random.default_rng(3))
    got = TrainDataset(pcfg, yaw_list=YAWS,
                       contains_device="cpu").get_color_sampling(
        "subj1", 1, rng=np.random.default_rng(3))
    for k in ("color_samples", "rgbs"):
        np.testing.assert_array_equal(got[k], want[k])
    mask = np.asarray(Image.open(os.path.join(color_root, "UV_MASK", "subj1",
                                              "00.png"))) > 0
    assert got["rgbs"].shape[1] == (n or mask.sum())
