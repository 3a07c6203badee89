"""The port's PRT shading (surs_tpu_torch/render/prt.py) and the PRT
branch of its dataset renderer against the JAX package's
(surs_tpu/render/prt.py, render/dataset_gen.py, apps/render_dataset.py),
on the CPU with the same numpy inputs.

Tolerances, each stated where it is used:
  * numpy code copied (fibonacci_sphere, RAW_TO_CONV) and the voxel grid
    (the same winding-number labels): equal;
  * float32 element-wise code (irradiance_basis, prt_shading): 1e-6;
  * the march's sample distances: jnp.linspace's bit for bit at the
    arguments compute_prt gives them on the 327,680-face body (about 800
    distances); over the test meshes' plans and a sweep of arguments at
    least 99.9 % of the values, the rest one ulp apart (XLA contracts the
    formula into FMAs where it keeps its loop, and folds the constants
    of a short loop it unrolls without them);
  * visibility from the same float32 inputs: equal booleans on all but
    VIS_SHARE = 1e-3 of the rays;
  * compute_prt with the same normals: within 1e-5 on at least 99 % of
    the vertices, the rest within one direction's weight
    4 pi / n_dirs * max|Y| (a flipped ray); from the mesh (the port's
    normals sum in another order) the same rule;
  * sh_rotation_matrix: 1e-5 (a least-squares fit of float32 bases);
  * rendered views: masks on 99.9 % of the pixels, RGB within 1 LSB on
    99.9 % (tests/test_torch_render.py's rule);
  * the ``_prt.npy`` cache of render_dataset: compute_prt's rule.
"""

import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surs_tpu.render import dataset_gen as jax_dataset_gen
from surs_tpu.render import prt as jax_prt
from surs_tpu.render.shading import vertex_normals as jax_vertex_normals
from surs_tpu_torch.apps import render_dataset as render_cli
from surs_tpu_torch.render import dataset_gen, prt
from surs_tpu_torch.render.shading import sh9_basis
from chip_smoke import HR_LEVEL, body_mesh
from tests.test_data import cube_mesh
from tests.test_prt import icosphere
from tests.test_torch_render import (RGB_SHARE, assert_same_dataset,
                                     humanoid, tree, write_objs)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = 1e-6
PRT_TOL = 1e-5
PRT_SHARE = 0.99
VIS_SHARE = 1e-3
LINSPACE_SHARE = 0.999
ROT_TOL = 1e-5
Y_MAX = 1.0925484305920792            # max |Y_i| of the SH9 basis


def two_spheres():
    """A sphere beside a smaller one: concave, so some rays are
    occluded (642 vertices, 1,280 faces)."""
    va, fa = icosphere(2, 0.5)
    vb, fb = icosphere(2, 0.3)
    vb = vb + np.float32([0.55, 0.0, 0.0])
    return np.concatenate([va, vb]), np.concatenate([fa, fb + len(va)])


def jax_normals(v, f):
    return np.array(jax_vertex_normals(jnp.asarray(v),
                                       jnp.asarray(f, jnp.int32)))


def assert_transfer_close(got, want, n_dirs):
    """compute_prt's rule: 99 % of the vertices within PRT_TOL, every
    vertex within one direction's weight."""
    err = np.abs(got - want).max(axis=1)
    assert (err <= PRT_TOL).mean() >= PRT_SHARE, np.sort(err)[-10:]
    assert err.max() <= 4 * np.pi / n_dirs * Y_MAX + PRT_TOL, err.max()


# ----------------------------------------------------------- the basis --
@pytest.mark.parametrize("n", [16, 128, 400])
def test_fibonacci_sphere_and_raw_to_conv_equal(n):
    np.testing.assert_array_equal(prt.fibonacci_sphere(n),
                                  jax_prt.fibonacci_sphere(n))
    np.testing.assert_array_equal(prt.RAW_TO_CONV, jax_prt.RAW_TO_CONV)
    assert prt.RAW_TO_CONV.dtype == jax_prt.RAW_TO_CONV.dtype


def test_irradiance_basis_matches_jax():
    n = np.random.default_rng(0).standard_normal((257, 3)).astype(
        np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    got = prt.irradiance_basis(torch.from_numpy(n)).numpy()
    want = np.asarray(jax_prt.irradiance_basis(jnp.asarray(n)))
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)


def test_prt_shading_matches_jax():
    rng = np.random.default_rng(1)
    t = rng.standard_normal((100, 9)).astype(np.float32)
    for sh in (rng.standard_normal(9), rng.standard_normal((9, 3))):
        got = prt.prt_shading(torch.from_numpy(t), sh).numpy()
        want = np.asarray(jax_prt.prt_shading(jnp.asarray(t), sh))
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)


def test_sh_rotation_matrix_matches_jax():
    for yaw in (0.0, 37.0, 200.0):
        th = np.deg2rad(yaw)
        R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                      [-np.sin(th), 0, np.cos(th)]])
        np.testing.assert_allclose(prt.sh_rotation_matrix(R),
                                   jax_prt.sh_rotation_matrix(R),
                                   rtol=0, atol=ROT_TOL)


# ------------------------------------------------------------ the march --
def test_voxelize_occupancy_matches_jax():
    v, f = two_spheres()
    occ, b_min, cell = prt.voxelize_occupancy(v, f, grid=24, device="cpu")
    jocc, jb_min, jcell = jax_prt.voxelize_occupancy(v, f, grid=24)
    assert occ.dtype == torch.bool and occ.shape == (24, 24, 24)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    np.testing.assert_array_equal(b_min, jb_min)
    np.testing.assert_array_equal(cell, jcell)
    assert 0 < occ.sum() < occ.numel()


def jnp_linspace(t0, t1, n):
    """jnp.linspace as _visibility runs it: under jit, t0 and t1
    traced."""
    return np.asarray(jax.jit(lambda a, b: jnp.linspace(
        a, b, n, dtype=jnp.float32))(t0, t1))


def body_plan():
    """compute_prt's (t0, t1, n_steps) at grid 96 on chip_smoke.py's
    327,680-face body of four ellipsoids (about 800 steps)."""
    v, _ = body_mesh(HR_LEVEL)
    _, _, cell = prt.grid_points(v, 96)
    return prt.march_plan(v, cell, 2.0, None)


def test_march_distances_equal_jnp_linspace():
    """Bit for bit at the body's plan; on the test meshes' plans and a
    sweep of arguments, LINSPACE_SHARE of the values (the rest an ulp
    apart, where XLA unrolled a short loop and folded its constants)."""
    t0, t1, n = body_plan()
    assert n > 700
    np.testing.assert_array_equal(prt.march_distances(t0, t1, n),
                                  jnp_linspace(t0, t1, n))
    v, _ = two_spheres()
    plans = [prt.march_plan(v, prt.grid_points(v, g)[2], 2.0, None)
             for g in (24, 32)]
    rng = np.random.default_rng(2)
    plans += [(rng.random() * 0.5, rng.random() * 300 + 1,
               int(rng.integers(2, 1200))) for _ in range(40)]
    same = total = 0
    for t0, t1, n in plans:
        got, want = prt.march_distances(t0, t1, n), jnp_linspace(t0, t1, n)
        assert got.dtype == np.float32 and got.shape == want.shape
        assert np.abs(got.view(np.int32) - want.view(np.int32)).max() <= 1
        same += (got == want).sum()
        total += n
    assert same / total >= LINSPACE_SHARE, same / total


def test_visibility_matches_jax():
    """The same float32 inputs through both: the origins off the two
    spheres' surface, 64 directions, the JAX occupancy grid."""
    v, f = two_spheres()
    n = jax_normals(v, f)
    jocc, b_min, cell = jax_prt.voxelize_occupancy(v, f, grid=32)
    t0, t1, n_steps = prt.march_plan(v, cell, 2.0, None)
    orig = (v + np.float32(t0) * n).astype(np.float32)
    dirs = prt.fibonacci_sphere(64)
    inv_cell = (1.0 / cell).astype(np.float32)
    want = np.asarray(jax_prt._visibility(
        jnp.asarray(orig), jnp.asarray(n), jnp.asarray(dirs), jocc,
        jnp.asarray(b_min, jnp.float32), jnp.asarray(inv_cell), t0, t1,
        n_steps=n_steps))
    got = prt.visibility(
        torch.from_numpy(orig), torch.from_numpy(dirs),
        torch.from_numpy(np.array(jocc)),
        torch.from_numpy(b_min.astype(np.float32)),
        torch.from_numpy(inv_cell), t0, t1, n_steps=n_steps).numpy()
    assert got.dtype == np.bool_ and got.shape == want.shape
    assert 0.05 < (~want).mean() < 0.95       # some rays occluded
    assert (got != want).mean() <= VIS_SHARE, (got != want).sum()


def test_compute_prt_matches_jax():
    """With the JAX normals given to both, and from the mesh."""
    v, f = two_spheres()
    n = jax_normals(v, f)
    kw = dict(n_dirs=64, grid=24)
    want = jax_prt.compute_prt(v, f, normals=n, **kw)
    got = prt.compute_prt(v, f, normals=n, device="cpu", **kw)
    assert got.dtype == np.float32 and got.shape == (len(v), 9)
    assert_transfer_close(got, want, kw["n_dirs"])
    assert_transfer_close(prt.compute_prt(v, f, device="cpu", **kw), want,
                          kw["n_dirs"])


# ---------------------------------------- the JAX file's own contracts --
def test_unoccluded_prt_matches_analytic_irradiance():
    verts, faces = icosphere(subdiv=2, r=0.5)
    t = prt.compute_prt(verts, faces, n_dirs=400, grid=48, n_steps=24,
                        device="cpu")
    n = jax_normals(verts, faces)
    H = prt.irradiance_basis(torch.from_numpy(n)).numpy()
    np.testing.assert_allclose(t[:, 0], H[:, 0], rtol=0.12)
    assert np.median(np.abs(t - H).max(axis=1)) < 0.12


def test_occlusion_darkens_transfer():
    half, gap = 0.5, 0.08
    a, b = cube_mesh(half=half), cube_mesh(half=half)
    a_verts = a.verts * np.array([1, 0.05, 1], np.float32) \
        + np.array([0, gap + 0.05 * half * 2, 0], np.float32)
    b_verts = b.verts * np.array([1, 0.05, 1], np.float32)
    verts = np.concatenate([a_verts, b_verts])
    faces = np.concatenate([a.faces, b.faces + len(a_verts)])
    t = prt.compute_prt(verts, faces, n_dirs=300, grid=64, n_steps=48,
                        device="cpu")
    idx = np.arange(len(verts))
    lower_top = np.where((idx >= len(a_verts))
                         & (verts[:, 1] > b_verts[:, 1].mean()))[0]
    upper_top = np.where((idx < len(a_verts))
                         & (verts[:, 1] > a_verts[:, 1].mean()))[0]
    assert lower_top.size > 0
    assert t[lower_top, 0].mean() < 0.9 * t[upper_top, 0].mean()
    assert t[upper_top, 0].mean() > 0.8
    occ, b_min, cell = prt.voxelize_occupancy(verts, faces, grid=64,
                                              device="cpu")
    probe = torch.tensor([[0.0, gap / 2, 0.0]])
    args = (occ, torch.from_numpy(b_min.astype(np.float32)),
            torch.from_numpy((1.0 / cell).astype(np.float32)), 0.005, 2.0)
    vis = prt.visibility(probe, torch.tensor([[0.0, 1, 0], [0, -1, 0]]),
                         *args, n_steps=64)
    assert not vis[0, 0] and not vis[0, 1]    # both slabs block
    assert prt.visibility(probe, torch.tensor([[1.0, 0, 0]]), *args,
                          n_steps=64)[0, 0]   # the gap is clear


def test_sh_rotation_exact_for_band_limited():
    rng = np.random.default_rng(0)
    th = np.deg2rad(37.0)
    R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                  [-np.sin(th), 0, np.cos(th)]], np.float32)
    M = prt.sh_rotation_matrix(R)
    d = prt.fibonacci_sphere(64)
    Y = sh9_basis(torch.from_numpy(d)).numpy()
    Yr = sh9_basis(torch.from_numpy(d @ R)).numpy()
    np.testing.assert_allclose(Yr, Y @ M.T, atol=1e-5)
    c = rng.standard_normal(9).astype(np.float32)
    np.testing.assert_allclose(Yr @ c, Y @ (M.T @ c), atol=1e-5)


# ----------------------------------------------------- dataset renderer --
def seeded_transfer(v, f, seed=0):
    """Transfer vectors for a mesh from a seed: the analytic basis at the
    normals, each vertex dimmed by a factor in [0.3, 1]."""
    n = jax_normals(v, f)
    H = prt.irradiance_basis(torch.from_numpy(n)).numpy()
    k = np.random.default_rng(seed).uniform(0.3, 1.0, (len(v), 1))
    return (H * k).astype(np.float32)


def test_render_views_prt_matches_jax():
    """The PRT views at 32 px: masks and RGB as the SH views' rule,
    PARAM dicts equal; lit, and different from the SH views."""
    v, f = humanoid(32)
    t = seeded_transfer(v, f)
    yaws = [0, 90, 200]
    got = list(dataset_gen.render_views(v, f, 32, yaws, prt=t,
                                        device="cpu"))
    want = list(jax_dataset_gen.render_views(v, f, 32, yaws, prt=t))
    plain = list(dataset_gen.render_views(v, f, 32, yaws, device="cpu"))
    for (_, grgb, gm, gp), (_, wrgb, wm, wp), (_, prgb, _, _) in zip(
            got, want, plain):
        assert (gm != wm).mean() <= 1 - RGB_SHARE
        close = (np.abs(grgb.astype(int) - wrgb.astype(int)) <= 1).all(-1)
        assert close.mean() >= RGB_SHARE
        for k in wp:
            np.testing.assert_array_equal(gp[k], wp[k], err_msg=k)
        assert grgb[gm > 0].mean() > 10 and (grgb != prgb).any()


def test_render_dataset_prt_matches_jax(tmp_path):
    """render_dataset(use_prt=True) on two subjects: the same layout and
    images as the JAX package's, both _prt.npy caches within
    compute_prt's rule; a second call reuses the cache, and a cache of
    another vertex count is recomputed."""
    objs = {}
    for who in ("port", "jax"):
        objs[who] = str(tmp_path / who / "GEO" / "OBJ")
        write_objs(objs[who])
    kw = dict(load_size=32, yaw_step=180, use_prt=True, prt_dirs=16,
              prt_grid=16)
    dataset_gen.render_dataset(objs["port"], str(tmp_path / "port"),
                               device="cpu", **kw)
    jax_dataset_gen.render_dataset(objs["jax"], str(tmp_path / "jax"),
                                   **kw)
    for s in ("a", "b"):
        got = np.load(os.path.join(objs["port"], f"{s}_prt.npy"))
        want = np.load(os.path.join(objs["jax"], f"{s}_prt.npy"))
        assert got.shape == want.shape and got.dtype == np.float32
        assert_transfer_close(got, want, 16)
    for who in ("port", "jax"):
        os.rename(tmp_path / who / "GEO", tmp_path / f"geo_{who}")
    assert tree(str(tmp_path / "port"))[:2] == ["MASK/a/0_0_00.png",
                                                "MASK/a/180_0_00.png"]
    assert_same_dataset(str(tmp_path / "port"), str(tmp_path / "jax"))
    # the cache: reused as it is, recomputed when the mesh changed
    obj_dir = str(tmp_path / "geo_port" / "OBJ")
    marker = np.full_like(np.load(os.path.join(obj_dir, "a_prt.npy")), 0.5)
    np.save(os.path.join(obj_dir, "a_prt.npy"), marker)
    np.save(os.path.join(obj_dir, "b_prt.npy"), marker[:5])
    dataset_gen.render_dataset(obj_dir, str(tmp_path / "again"),
                               device="cpu", **kw)
    np.testing.assert_array_equal(
        np.load(os.path.join(obj_dir, "a_prt.npy")), marker)
    again = np.load(os.path.join(obj_dir, "b_prt.npy"))
    assert again.shape[0] > 5
    assert_transfer_close(again, np.load(os.path.join(
        str(tmp_path / "geo_jax" / "OBJ"), "b_prt.npy")), 16)


def test_render_dataset_prt_cli_matches_jax(tmp_path, monkeypatch):
    """``--prt`` on both CLIs over the same OBJ folder content and the
    same _prt.npy caches (the CLIs' 96^3, 128-direction transfer is
    left to the card): the same files, masks and images."""
    roots = [tmp_path / "port", tmp_path / "jax"]
    for r in roots:
        write_objs(str(r / "GEO" / "OBJ"))
    obj = str(roots[0] / "GEO" / "OBJ")
    from surs_tpu_torch.recon.mesh_io import load_obj
    for s in ("a", "b"):
        v, f = load_obj(os.path.join(obj, f"{s}_HR.obj"))
        t = seeded_transfer(v, f, seed=ord(s))
        for r in roots:
            np.save(str(r / "GEO" / "OBJ" / f"{s}_prt.npy"), t)
    flags = ["--loadSize", "32", "--yaw_step", "120", "--prt"]
    render_cli.main(["--dataroot", str(roots[0]), "--device", "cpu"]
                    + flags)
    monkeypatch.setattr(sys, "argv", ["render_dataset.py", "--dataroot",
                                      str(roots[1])] + flags)
    runpy.run_path(os.path.join(ROOT, "apps", "render_dataset.py"),
                   run_name="__main__")
    for r in roots:
        os.rename(r / "GEO", tmp_path / f"geo_{r.name}")
    assert len(tree(str(roots[0]))) == 2 * 3 * 3
    assert_same_dataset(str(roots[0]), str(roots[1]))
