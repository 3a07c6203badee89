"""The port's renderer against the JAX package's, on the CPU: the
synthetic humanoid (synth), the camera, SH shading, the z-buffer
rasterizer, the dataset renderer and its CLI.

Tolerances, each stated where it is used:
  * numpy code copied verbatim (the capsule table, humanoid_variant,
    humanoid_sdf_np): equal; the camera's float64 matrices: 1e-12;
  * float32 element-wise code (humanoid_sdf / humanoid_volume, vertex
    normals, the SH basis and shading): 1e-6;
  * rasterize: masks differ on at most 0.1 % of the pixels, image and
    depth within 1e-4 where both masks are set. The candidates' depths
    are compared for exact equality in the tie-break, and XLA may
    contract the barycentric sums into FMAs where torch does not, so a
    pixel on an edge may go to the other face;
  * rendered views: RGB within 1 LSB on 99.9 % of the pixels (the uint8
    cast truncates, so an ulp of shading can flip a level).
"""

import os
import runpy
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from surs_tpu.render import camera as jax_camera
from surs_tpu.render import dataset_gen as jax_dataset_gen
from surs_tpu.render import rasterizer as jax_rasterizer
from surs_tpu.render import shading as jax_shading
from surs_tpu.recon.mesh_io import save_obj_mesh as jax_save_obj
from surs_tpu.utils import synth as jax_synth
from surs_tpu_torch.apps import render_dataset as render_cli
from surs_tpu_torch.probes.subject_demo import humanoid_mesh
from surs_tpu_torch.recon.mesh_io import load_obj
from surs_tpu_torch.render import (camera, dataset_gen, rasterizer,
                                   shading)
from surs_tpu_torch.utils import synth

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MASK_SHARE = 1e-3
RASTER_TOL = 1e-4
F32_TOL = 1e-6
CAM_TOL = 1e-12
RGB_SHARE = 0.999


def humanoid(R=40, detail=0.012):
    """The capsule humanoid meshed by the port's marching tetrahedra at
    R^3 over [-0.85, 1.0]^3 (7,552 faces at R = 40)."""
    return humanoid_mesh(detail, R, device="cpu")


def cube():
    """A unit cube turned to show three faces, in uv space."""
    v = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                  for z in (-1, 1)], np.float64) * 0.5
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                  [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                  [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int64)
    R = camera.yaw_pitch_rotation(35.0, 25.0)
    return (v @ R.T * 0.7 + [0.0, 0.0, 2.0]).astype(np.float32), f


def depth_pair():
    """Two overlapping triangles, the second in front of the first, and
    a third on the second's own vertices (duplicated): every depth ties
    exactly with the second's, and the smaller face id wins."""
    v = np.array([[-0.8, -0.8, 1.0], [0.8, -0.6, 1.0], [0.0, 0.8, 1.0],
                  [-0.6, 0.7, 0.5], [0.7, 0.6, 0.5], [0.1, -0.7, 0.5]],
                 np.float32)
    v = np.concatenate([v, v[3:]])
    f = np.array([[0, 1, 2], [3, 4, 5], [6, 7, 8]], np.int64)
    return v, f


def humanoid_uv(res=64):
    v, f = humanoid()
    cam = camera.fit_camera(v, res)
    return cam.world_to_uv(v, res).astype(np.float32), f


MESHES = {"cube": cube, "depth_pair": depth_pair, "humanoid": humanoid_uv}


def both_rasterize(v, f, attrs, res, patch):
    jimg, jmask, jdepth = (np.asarray(x) for x in jax_rasterizer.rasterize(
        jnp.asarray(v), jnp.asarray(f, jnp.int32), jnp.asarray(attrs),
        res=res, patch=patch))
    timg, tmask, tdepth = (x.numpy() for x in rasterizer.rasterize(
        torch.from_numpy(v), torch.from_numpy(f), torch.from_numpy(attrs),
        res=res, patch=patch))
    return (jimg, jmask, jdepth), (timg, tmask, tdepth)


# --------------------------------------------------------------- synth --
def test_capsules_equal():
    np.testing.assert_array_equal(synth._CAPSULES, jax_synth._CAPSULES)


@pytest.mark.parametrize("variant", [0, 1, 5])
def test_humanoid_variant_equal(variant):
    for got, want in zip(synth.humanoid_variant(variant),
                         jax_synth.humanoid_variant(variant)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("detail", [0.0, 0.012])
def test_humanoid_sdf_np_equal(detail, rng):
    p = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    caps, _, freqs = jax_synth.humanoid_variant(2)
    np.testing.assert_array_equal(
        synth.humanoid_sdf_np(p, detail=detail),
        jax_synth.humanoid_sdf_np(p, detail=detail))
    np.testing.assert_array_equal(
        synth.humanoid_sdf_np(p, caps, detail, freqs),
        jax_synth.humanoid_sdf_np(p, caps, detail, freqs))


@pytest.mark.parametrize("detail", [0.0, 0.012])
def test_humanoid_sdf_matches_jax(detail, rng):
    """float32 element-wise: within 1e-6."""
    p = rng.uniform(-1, 1, (3, 2000)).astype(np.float32)
    got = synth.humanoid_sdf(*torch.from_numpy(p), detail=detail).numpy()
    want = np.asarray(jax_synth.humanoid_sdf_jnp(*jnp.asarray(p),
                                                 detail=detail))
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("R,detail,lo,hi", [(24, 0.012, -1.0, 1.0),
                                            (17, 0.0, -0.85, 1.0)])
def test_humanoid_volume_matches_jax(R, detail, lo, hi):
    """Within 1e-6 (linspace may differ by an ulp of the grid)."""
    got = synth.humanoid_volume(R, detail, lo, hi, device="cpu").numpy()
    want = np.asarray(jax_synth.humanoid_volume(R, detail, lo, hi))
    assert got.shape == want.shape == (R, R, R)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)


def test_humanoid_volume_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synth.humanoid_volume(8)


# -------------------------------------------------------------- camera --
@pytest.mark.parametrize("yaw,pitch", [(0.0, 0.0), (30.0, 0.0),
                                       (217.0, -12.5)])
def test_yaw_pitch_rotation_equal(yaw, pitch):
    np.testing.assert_array_equal(camera.yaw_pitch_rotation(yaw, pitch),
                                  jax_camera.yaw_pitch_rotation(yaw, pitch))


@pytest.mark.parametrize("load_size,coverage", [(32, 0.9), (512, 0.75)])
def test_fit_camera_and_world_to_uv_match_jax(load_size, coverage):
    """Float64 camera matrices: within 1e-12."""
    v, _ = humanoid(24)
    got = camera.fit_camera(v, load_size, coverage)
    want = jax_camera.fit_camera(v, load_size, coverage)
    assert abs(got.ortho_ratio - want.ortho_ratio) <= CAM_TOL
    np.testing.assert_allclose(got.center, want.center, rtol=0,
                               atol=CAM_TOL)
    R = camera.yaw_pitch_rotation(60.0, 10.0)
    got.R, want.R = R, R
    for k, val in want.param_dict().items():
        np.testing.assert_allclose(got.param_dict()[k], val, rtol=0,
                                   atol=CAM_TOL, err_msg=k)
    np.testing.assert_allclose(got.world_to_uv(v, load_size),
                               want.world_to_uv(v, load_size), rtol=0,
                               atol=CAM_TOL)


# ------------------------------------------------------------- shading --
def test_vertex_normals_match_jax():
    """Within 1e-6 (scatter-add order)."""
    v, f = humanoid(24)
    got = shading.vertex_normals(torch.from_numpy(v),
                                 torch.from_numpy(f)).numpy()
    want = np.asarray(jax_shading.vertex_normals(jnp.asarray(v),
                                                 jnp.asarray(f, jnp.int32)))
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)


def unit_normals(rng, n=300):
    x = rng.normal(size=(n, 3)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_sh9_basis_matches_jax(rng):
    n = unit_normals(rng)
    np.testing.assert_allclose(
        shading.sh9_basis(torch.from_numpy(n)).numpy(),
        np.asarray(jax_shading.sh9_basis(jnp.asarray(n))), rtol=0,
        atol=F32_TOL)


@pytest.mark.parametrize("channels", [None, 3])
def test_sh_shading_matches_jax(channels, rng):
    n = unit_normals(rng)
    sh = (shading.default_lighting() if channels is None
          else rng.normal(size=(9, channels)).astype(np.float32))
    np.testing.assert_array_equal(shading.default_lighting(),
                                  jax_shading.default_lighting())
    np.testing.assert_allclose(
        shading.sh_shading(torch.from_numpy(n), sh).numpy(),
        np.asarray(jax_shading.sh_shading(jnp.asarray(n), sh)), rtol=0,
        atol=F32_TOL)


def test_lambert_shading_matches_jax(rng):
    n = unit_normals(rng)
    np.testing.assert_allclose(
        shading.lambert_shading(torch.from_numpy(n), (0.3, -0.2, -1.0),
                                0.25).numpy(),
        np.asarray(jax_shading.lambert_shading(jnp.asarray(n),
                                               (0.3, -0.2, -1.0), 0.25)),
        rtol=0, atol=F32_TOL)


# ---------------------------------------------------------- rasterizer --
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_rasterize_matches_jax(mesh, rng):
    """Masks differ on at most 0.1 % of the 64 x 64 pixels; image and
    depth within 1e-4 where both are set; off both masks image 0 and
    depth 1e9 on both sides."""
    v, f = MESHES[mesh]()
    attrs = rng.uniform(0, 1, (v.shape[0], 3)).astype(np.float32)
    (ji, jm, jd), (ti, tm, td) = both_rasterize(v, f, attrs, 64, 16)
    assert tm.dtype == np.bool_ and ti.shape == (64, 64, 3)
    assert jm.sum() > 0
    assert (jm != tm).mean() <= MASK_SHARE
    both = jm & tm
    np.testing.assert_allclose(ti[both], ji[both], rtol=0, atol=RASTER_TOL)
    np.testing.assert_allclose(td[both], jd[both], rtol=0, atol=RASTER_TOL)
    off = ~jm & ~tm
    assert (ti[off] == 0).all() and (td[off] == 1e9).all()
    assert (ji[off] == 0).all() and (jd[off] == 1e9).all()


def test_rasterize_depth_order_and_tie():
    """The front triangle covers the back one; on the exact depth tie the
    smaller face id's attributes win."""
    v, f = depth_pair()
    attrs = np.zeros((9, 1), np.float32)
    attrs[0:3] = 1.0
    attrs[3:6] = 2.0
    attrs[6:9] = 3.0
    img, mask, depth = rasterizer.rasterize(
        torch.from_numpy(v), torch.from_numpy(f), torch.from_numpy(attrs),
        res=64, patch=64)
    img = img.numpy()[..., 0]
    # pixel (32, 20) lies in all three: face 1 (z 0.5, id 1 < 2) wins
    assert abs(img[20, 32] - 2.0) < 1e-5
    assert abs(depth[20, 32].item() - 0.5) < 1e-6
    vals = set(np.unique(np.round(img[mask.numpy()], 4)).tolist())
    assert vals == {1.0, 2.0}


def test_rasterize_empty_faces():
    img, mask, depth = rasterizer.rasterize(
        torch.zeros((3, 3)), torch.zeros((0, 3), dtype=torch.int64),
        torch.zeros((3, 2)), res=8)
    assert img.shape == (8, 8, 2) and not mask.any()
    assert (depth == 1e9).all() and (img == 0).all()


# ----------------------------------------------------- dataset renderer --
def test_render_views_match_jax():
    """RGB within 1 LSB on 99.9 % of the 32 x 32 pixels, masks on
    99.9 %, PARAM dicts equal."""
    v, f = humanoid(32)
    yaws = [0, 90, 200]
    got = list(dataset_gen.render_views(v, f, 32, yaws, device="cpu"))
    want = list(jax_dataset_gen.render_views(v, f, 32, yaws))
    for (gy, grgb, gm, gp), (wy, wrgb, wm, wp) in zip(got, want):
        assert gy == wy and grgb.dtype == np.uint8 and gm.dtype == np.uint8
        assert grgb.shape == (32, 32, 3) and gm.shape == (32, 32)
        assert (gm != wm).mean() <= 1 - RGB_SHARE
        close = (np.abs(grgb.astype(int) - wrgb.astype(int)) <= 1).all(-1)
        assert close.mean() >= RGB_SHARE
        assert sorted(gp) == sorted(wp)
        for k in wp:
            np.testing.assert_array_equal(gp[k], wp[k], err_msg=k)


def test_render_views_prt_raises():
    """PRT shading is ported (render/prt.py) and no longer raises:
    render_views(prt=) gives the JAX package's view of the cube, masks
    and RGB under the views' rule (tests/test_torch_prt.py holds the
    rest of the PRT path)."""
    v, f = cube()
    t = np.random.default_rng(5).uniform(0.0, 1.0, (8, 9)).astype(
        np.float32)
    _, grgb, gm, _ = next(dataset_gen.render_views(v, f, 16, [30],
                                                   device="cpu", prt=t))
    _, wrgb, wm, _ = next(jax_dataset_gen.render_views(v, f, 16, [30],
                                                       prt=t))
    assert gm.any() and (gm != wm).mean() <= 1 - RGB_SHARE
    close = (np.abs(grgb.astype(int) - wrgb.astype(int)) <= 1).all(-1)
    assert close.mean() >= RGB_SHARE


def test_render_views_need_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    v, f = cube()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(dataset_gen.render_views(v, f, 16, [0]))


def write_objs(obj_dir):
    os.makedirs(obj_dir)
    for name, R in (("a", 28), ("b", 22)):
        v, f = humanoid(R)
        jax_save_obj(os.path.join(obj_dir, f"{name}_HR.obj"), v, f)


def tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def assert_same_dataset(got_root, want_root):
    """The same files; PARAM dicts equal; masks equal on 99.9 % of the
    pixels and the decoded JPEGs within 1 LSB on 99.9 %."""
    assert tree(got_root) == tree(want_root)
    for rel in tree(want_root):
        g, w = (os.path.join(r, rel) for r in (got_root, want_root))
        if rel.endswith(".npy"):
            gp = np.load(g, allow_pickle=True).item()
            wp = np.load(w, allow_pickle=True).item()
            assert sorted(gp) == sorted(wp)
            for k in wp:
                np.testing.assert_array_equal(gp[k], wp[k], err_msg=rel)
        elif rel.endswith((".png", ".jpg")):
            gi = np.asarray(Image.open(g)).astype(int)
            wi = np.asarray(Image.open(w)).astype(int)
            assert gi.shape == wi.shape
            close = np.abs(gi - wi) <= (0 if rel.endswith(".png") else 1)
            if close.ndim == 3:
                close = close.all(-1)
            assert close.mean() >= RGB_SHARE, rel


def test_render_dataset_matches_jax(tmp_path):
    obj_dir = str(tmp_path / "GEO" / "OBJ")
    write_objs(obj_dir)
    got, want = str(tmp_path / "port"), str(tmp_path / "jax")
    dataset_gen.render_dataset(obj_dir, got, load_size=32, yaw_step=120,
                               device="cpu")
    jax_dataset_gen.render_dataset(obj_dir, want, load_size=32,
                                   yaw_step=120)
    assert tree(got)[0] == "MASK/a/0_0_00.png"
    assert len(tree(got)) == 2 * 3 * 3
    assert_same_dataset(got, want)


def test_render_dataset_cli_matches_jax(tmp_path, monkeypatch):
    """``python -m surs_tpu_torch.apps.render_dataset`` against
    ``apps/render_dataset.py`` on one tiny directory."""
    roots = [tmp_path / "port", tmp_path / "jax"]
    for r in roots:
        write_objs(str(r / "GEO" / "OBJ"))
    flags = ["--loadSize", "32", "--yaw_step", "180", "--subjects", "b"]
    render_cli.main(["--dataroot", str(roots[0]), "--device", "cpu"]
                    + flags)
    monkeypatch.setattr(sys, "argv", ["render_dataset.py", "--dataroot",
                                      str(roots[1])] + flags)
    runpy.run_path(os.path.join(ROOT, "apps", "render_dataset.py"),
                   run_name="__main__")
    for r in roots:
        os.rename(r / "GEO", tmp_path / f"geo_{r.name}")
    assert tree(str(roots[0])) == ["MASK/b/0_0_00.png", "MASK/b/180_0_00.png",
                                   "PARAM/b/0_0_00.npy",
                                   "PARAM/b/180_0_00.npy",
                                   "RENDER/b/0_0_00.jpg",
                                   "RENDER/b/180_0_00.jpg"]
    assert_same_dataset(str(roots[0]), str(roots[1]))


@pytest.mark.parametrize("flag,item", [("--prt", "A14"), ("--uv", "A11")])
def test_render_dataset_cli_unported_flags_raise(tmp_path, flag, item):
    """Both flags are ported and write their layouts: --prt (A14) the
    PRT-shaded RENDER / MASK / PARAM views from each subject's
    ``_prt.npy`` cache (seeded here with the meshes' vertex count, so
    the CLI reuses it; tests/test_torch_prt.py holds the views and a
    computed cache to the JAX CLI's), --uv (A11) the UV layout
    (tests/test_torch_uv.py holds it to the JAX CLI)."""
    write_objs(str(tmp_path / "GEO" / "OBJ"))
    argv = ["--dataroot", str(tmp_path), "--device", "cpu", "--loadSize",
            "16", "--yaw_step", "180", flag]
    if flag == "--uv":
        render_cli.main(argv + ["--uv_size", "16"])
        for d in ("UV_MASK/a/00.png", "UV_POS/b/00.exr",
                  "UV_RENDER/b/180_0_00.jpg", "UV_NORMAL/a/00.png"):
            assert (tmp_path / d).is_file(), d
        return
    caches = {}
    for s in ("a", "b"):
        n = len(load_obj(str(tmp_path / "GEO" / "OBJ" / f"{s}_HR.obj"))[0])
        caches[s] = np.random.default_rng(ord(s)).uniform(
            0.2, 1.0, (n, 9)).astype(np.float32)
        np.save(str(tmp_path / "GEO" / "OBJ" / f"{s}_prt.npy"), caches[s])
    render_cli.main(argv)
    for s in ("a", "b"):
        for d in (f"RENDER/{s}/0_0_00.jpg", f"MASK/{s}/180_0_00.png",
                  f"PARAM/{s}/180_0_00.npy"):
            assert (tmp_path / d).is_file(), d
        np.testing.assert_array_equal(
            np.load(str(tmp_path / "GEO" / "OBJ" / f"{s}_prt.npy")),
            caches[s])
    assert np.asarray(Image.open(tmp_path / "MASK/a/0_0_00.png")).any()
