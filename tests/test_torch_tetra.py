"""Marching tetrahedra in the port against the JAX package, on the CPU:

* ``recon/tetra.py``'s torch extractor against ``surs_tpu.recon.tetra``
  (numpy): the same arrays exactly, vertices in sorted edge-key order and
  faces in emission order, for an interior sphere, a sphere cut by the
  max planes, a noise field that reaches every tet case and an empty
  field; ``cell_chunk`` does not change the result;
* the host library's ``surs_marching_tetrahedra``
  (``surs_tpu_torch/csrc/mesh_native.cpp``) against the JAX package's
  native library: the same arrays exactly (first-appearance order), and
  the same mesh as the torch extractor as sets of quantised vertices and
  winding-preserving faces; its edge map grows past its first size;
* ``Reconstructor.extract_pair`` per backend and algorithm against the
  JAX ``extract_pair`` (arrays for the host backend, sets for the device
  backend, whose order differs in the JAX package), a set capacity
  raising, 'auto' falling back to the host and saying so;
* ``reconstruct`` / ``reconstruction`` with default arguments, the
  service through ``mc_algorithm='tets'``, the eval CLI with
  ``--mc_backend host`` and ``make_point_eval`` against the JAX package;
* ``resolve_config``'s values.

The fields of the two services agree to 1e-4 (float32 in another
summation order, tests/test_torch_pipeline.py), so meshes of the two
services are held to the same face counts and vertices within 2e-4 (in
memory) or 1e-3 (through OBJ files), as tests/test_torch_eval.py holds
them.
"""

import dataclasses
import os
import runpy
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surs_tpu.config import SuRSConfig as JConfig
from surs_tpu.recon import native as j_native
from surs_tpu.recon.mesh_io import load_obj as j_load_obj
from surs_tpu.recon.pipeline import Reconstructor as JReconstructor
from surs_tpu.recon.pipeline import make_point_eval as j_make_point_eval
from surs_tpu.recon.tetra import marching_tetrahedra as j_tets
from surs_tpu.serve import SuRSService as JService
from surs_tpu.serve import normalize_image as j_normalize_image
from surs_tpu_torch.apps.eval_surs import main
from surs_tpu_torch.config import SuRSConfig, resolve_config
from surs_tpu_torch.recon import native
from surs_tpu_torch.recon.marching import CapacityError, extract_isosurface
from surs_tpu_torch.recon.mesh_io import load_obj
from surs_tpu_torch.recon.pipeline import (Reconstructor, eval_calibration,
                                           make_point_eval, reconstruction)
from surs_tpu_torch.recon.tetra import _TETS, marching_tetrahedra
from surs_tpu_torch.serve import SuRSService, normalize_image
from test_torch_eval import (APP, CLI_FLAGS, COMMON, eval_root, nearest_gap,
                             reference_checkpoint, subject)

torch.set_num_threads(1)


def sphere_vol(n, center, r):
    g = np.stack(np.meshgrid(*([np.arange(n)] * 3), indexing="ij"), -1)
    d = np.sqrt(((g - np.asarray(center)) ** 2).sum(-1))
    return (0.5 + (r - d)).astype(np.float32)


VOLUMES = {
    "interior_sphere": lambda: sphere_vol(24, (11.5, 11.5, 11.5), 7.3),
    "boundary_cut_sphere": lambda: sphere_vol(16, (15.0, 15.0, 15.0), 9.1),
    "noise": lambda: np.random.default_rng(7).random(
        (9, 10, 11)).astype(np.float32),
    "empty": lambda: np.zeros((8, 8, 8), np.float32),
}


def canon_faces(verts, faces):
    """Faces as position-key triples, cyclically rotated so the smallest
    key is first (order-independent, winding-preserving), sorted
    (tests/test_tetra_device.py's)."""
    q = np.rint(np.asarray(verts, np.float64) * 4096.0).astype(np.int64)
    out = []
    for f in np.asarray(faces):
        keys = [tuple(q[i]) for i in f]
        r = keys.index(min(keys))
        out.append(tuple(keys[r:] + keys[:r]))
    return sorted(out)


def assert_same_mesh(vh, fh, vd, fd):
    """The same quantised vertex set and winding-preserving face set."""
    assert vh.shape == vd.shape, (vh.shape, vd.shape)
    assert fh.shape == fd.shape, (fh.shape, fd.shape)
    qh = sorted(map(tuple, np.rint(vh * 4096).astype(np.int64)))
    qd = sorted(map(tuple, np.rint(vd * 4096).astype(np.int64)))
    assert qh == qd
    assert canon_faces(vh, fh) == canon_faces(vd, fd)


# -------------------------------------------------------------- extractors --
@pytest.mark.parametrize("level", [0.5, 0.48])
@pytest.mark.parametrize("name", sorted(VOLUMES))
def test_torch_tets_equal_numpy(name, level):
    vol = VOLUMES[name]()
    want_v, want_f = j_tets(vol, level)
    got_v, got_f = marching_tetrahedra(torch.from_numpy(vol), level)
    assert got_v.dtype == torch.float32 and got_f.dtype == torch.int64
    assert (want_f.shape[0] > 0) == (name != "empty")
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(got_f.numpy(), want_f)


def test_noise_reaches_every_tet_case():
    vol = VOLUMES["noise"]()
    inside = vol > 0.5
    X, Y, Z = vol.shape
    offs = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                     [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]])
    corner = np.stack([inside[dx:X - 1 + dx, dy:Y - 1 + dy, dz:Z - 1 + dz]
                       for dx, dy, dz in offs], -1).reshape(-1, 8)
    cases = {int((corner[:, tet] * [1, 2, 4, 8]).sum(1)[i])
             for tet in _TETS for i in range(corner.shape[0])}
    assert cases == set(range(16))


@pytest.mark.parametrize("chunk", [5, 37, 1 << 20])
def test_cell_chunk_does_not_change_the_result(chunk):
    vol = torch.from_numpy(VOLUMES["interior_sphere"]())
    want_v, want_f = marching_tetrahedra(vol, 0.5)
    got_v, got_f = marching_tetrahedra(vol, 0.5, cell_chunk=chunk)
    torch.testing.assert_close(got_v, want_v, rtol=0, atol=0)
    torch.testing.assert_close(got_f, want_f, rtol=0, atol=0)


@pytest.mark.parametrize("level", [0.5, 0.48])
@pytest.mark.parametrize("name", sorted(VOLUMES))
def test_native_tets_equal_jax_native(name, level):
    assert j_native.available()
    vol = VOLUMES[name]()
    want_v, want_f = j_native.marching_tetrahedra(vol, level)
    got_v, got_f = native.marching_tetrahedra(vol, level)
    assert got_v.dtype == np.float32 and got_f.dtype == np.int64
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_f, want_f)


@pytest.mark.parametrize("name", sorted(VOLUMES))
def test_native_tets_equal_torch_as_sets(name):
    vol = VOLUMES[name]()
    nv, nf = native.marching_tetrahedra(vol, 0.5)
    tv, tf = marching_tetrahedra(torch.from_numpy(vol), 0.5)
    assert_same_mesh(nv, nf, tv.numpy(), tf.numpy())
    for backend in ("native", "auto"):
        v, f = extract_isosurface(torch.from_numpy(vol), 0.5, backend)
        np.testing.assert_array_equal(v, nv)
        np.testing.assert_array_equal(f, nf)
    v, f = extract_isosurface(vol, 0.5, "torch")
    np.testing.assert_array_equal(f, tf.numpy())


def test_native_edge_map_grows_past_initial_capacity():
    """The edge map starts at 2^21 slots for 2^20 vertices; this noise
    field has about 3 M crossing vertices. A map that did not grow would
    spin forever once full, so the extraction runs in a subprocess with
    a time limit (tests/test_recon.py:162)."""
    code = (
        "import numpy as np\n"
        "from surs_tpu_torch.recon import native\n"
        "rng = np.random.default_rng(7)\n"
        "vol = rng.random((96, 96, 96), dtype=np.float32)\n"
        "v, f = native.marching_tetrahedra(vol, 0.5)\n"
        "assert v.shape[0] > 2_200_000, v.shape\n"
        "assert f.min() >= 0 and f.max() < v.shape[0]\n"
        "print('verts', v.shape[0])\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], timeout=240,
                       capture_output=True, text=True, cwd=root)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "verts" in r.stdout


# ------------------------------------------------------------ extract_pair --
def pair_fields():
    hr = sphere_vol(20, (9.5, 9.5, 9.5), 6.2)
    lr = sphere_vol(20, (19.0, 9.0, 9.5), 8.1)      # cut by a max plane
    mat = np.diag([1 / 20, 1 / 20, 1 / 20, 1.0])
    mat[:3, 3] = -0.5
    return hr, lr, mat


@pytest.mark.parametrize("backend,algorithm", [
    ("host", None), ("device", "tets"), ("device", "cubes"), ("auto", None),
    ("device", None)])
def test_extract_pair_matches_jax(backend, algorithm):
    hr, lr, mat = pair_fields()
    caps = None if algorithm is None else {"algorithm": algorithm}
    want = list(JReconstructor.extract_pair(hr, lr, mat, 0.5, backend, caps))
    stats = {}
    got = list(Reconstructor.extract_pair(
        torch.from_numpy(hr), torch.from_numpy(lr), mat, 0.5, backend, caps,
        stats))
    assert stats["mc"] == ("host/tets" if backend == "host"
                           else f"device/{algorithm or 'tets'}")
    for (vg, fg), (vw, fw) in zip(got, want):
        assert fg.shape[0] > 0 and vg.dtype == np.float32
        vw, fw = np.asarray(vw), np.asarray(fw)
        if backend == "host":
            np.testing.assert_array_equal(vg, vw)
            np.testing.assert_array_equal(fg, fw)
        else:
            # world coordinates: quantise on the grid's own scale
            assert_same_mesh((vw + 0.5) * 20, fw, (vg + 0.5) * 20, fg)


def test_extract_pair_capacity_raises_and_auto_falls_back():
    hr, lr, mat = pair_fields()
    fields = (torch.from_numpy(hr), torch.from_numpy(lr))
    caps = {"algorithm": "tets", "max_cells": 16, "mesh": "ignored"}
    with pytest.raises(CapacityError, match="capacity exceeded: cells"):
        list(Reconstructor.extract_pair(*fields, mat, 0.5, "device", caps))
    for key in ("max_tris", "max_verts", "max_pts"):
        with pytest.raises(ValueError, match=f"capacity exceeded: "
                           f"{key[4:]}"):
            list(Reconstructor.extract_pair(*fields, mat, 0.5, "device",
                                            {key: 16}))
    stats = {}
    got = list(Reconstructor.extract_pair(*fields, mat, 0.5, "auto", caps,
                                          stats))
    assert stats["mc"] == "host/tets"
    assert "capacity exceeded" in stats["mc_fallback"]
    host = list(Reconstructor.extract_pair(*fields, mat, 0.5, "host"))
    for (vg, fg), (vh, fh) in zip(got, host):
        np.testing.assert_array_equal(vg, vh)
        np.testing.assert_array_equal(fg, fh)
    # the sharded backend (A13) keeps the JAX package's slab shapes: a
    # 20^3 field has Z % 32 != 0
    with pytest.raises(ValueError, match="sharded extraction needs"):
        list(Reconstructor.extract_pair(*fields, mat, 0.5, "sharded"))


# --------------------------------------------------- services and the CLI --
@pytest.fixture(scope="module")
def services():
    """The JAX and the port's tiny service on the same weights, both
    extracting by marching tetrahedra on the device."""
    jcfg = JConfig(serve_octree_mode="mono", mc_backend="device",
                   mc_algorithm="tets", **COMMON)
    jsvc = JService(jcfg, compilation_cache=False)
    import jax
    params = jax.tree_util.tree_map(np.asarray, jsvc.params)
    tsvc = SuRSService(SuRSConfig(mc_algorithm="tets", **COMMON),
                       params=params, device="cpu")
    return jsvc, tsvc


def test_reconstruct_defaults_match_jax(services):
    """With default arguments both extract by the host library's marching
    tetrahedra: with the same inside/outside signs the faces are the
    same arrays, and the vertices within the fields' gap."""
    jsvc, tsvc = services
    img, mask = subject()
    arr, _ = normalize_image(img, mask)
    j_arr, _ = j_normalize_image(img, mask)
    calib = eval_calibration(1)
    _, j_lr, j_hr = jsvc.rec.encode(jsvc.params, jnp.asarray(j_arr))
    want = jsvc.rec.reconstruct(jsvc.weights, j_lr, j_hr, calib, 32,
                                COMMON["b_min"], COMMON["b_max"],
                                num_samples=4096, init_resolution=8)
    _, t_lr, t_hr = tsvc.rec.encode(arr)
    stats = {}
    got = tsvc.rec.reconstruct(t_lr, t_hr, calib, 32, COMMON["b_min"],
                               COMMON["b_max"], num_samples=4096,
                               init_resolution=8, stats=stats)
    assert stats["mc"] == "host/tets"
    for i in (0, 2):
        vg, fg, vw, fw = got[i], got[i + 1], want[i], want[i + 1]
        assert fg.shape[0] > 0
        np.testing.assert_array_equal(fg, fw)
        np.testing.assert_allclose(vg, vw, rtol=0, atol=2e-4)
    func = reconstruction(tsvc.model, t_lr, t_hr, calib, 32,
                          COMMON["b_min"], COMMON["b_max"],
                          num_samples=4096, init_resolution=8)
    for a, b in zip(func, got):
        np.testing.assert_array_equal(a, b)


def test_service_tets_match_jax(services, tmp_path):
    """The service through cfg.mc_algorithm='tets' (gen_mesh) against the
    JAX service's device marching tetrahedra, file against file."""
    jsvc, tsvc = services
    assert (tsvc.cfg.mc_backend, tsvc.cfg.mc_algorithm) == ("device", "tets")
    img, mask = subject()
    want = jsvc.reconstruct(img, mask, "s", str(tmp_path / "jax"))
    stats = {}
    got = tsvc.reconstruct(img, mask, "s", str(tmp_path / "torch"), stats)
    assert stats["mc"] == "device/tets" and stats["extract_s"] > 0
    for p, q in zip(got, want):
        vg, fg = load_obj(p)
        vw, fw = j_load_obj(q)
        assert fg.shape[0] > 0 and fg.shape == fw.shape
        assert vg.shape == vw.shape
        assert max(nearest_gap(vg, vw), nearest_gap(vw, vg)) < 1e-3


def test_make_point_eval_matches_jax(services):
    jsvc, tsvc = services
    img, mask = subject()
    arr, _ = normalize_image(img, mask)
    calib = eval_calibration(1)
    _, j_lr, j_hr = jsvc.rec.encode(jsvc.params, jnp.asarray(arr))
    _, t_lr, t_hr = tsvc.rec.encode(arr)
    pts = np.random.default_rng(0).uniform(-0.5, 0.5, (3, 500)).astype(
        np.float32)
    want = j_make_point_eval(jsvc.model, jsvc.params, j_lr, j_hr,
                             jnp.asarray(calib))(jnp.asarray(pts))
    got = make_point_eval(tsvc.model, t_lr, t_hr, calib)(
        torch.from_numpy(pts))
    for g, w in zip(got, want):
        assert g.shape == (500,)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-4)


def test_cli_host_tets_match_the_jax_cli(tmp_path, monkeypatch, capsys):
    root = eval_root(tmp_path, names=("s",))
    ckpt = reference_checkpoint(str(tmp_path / "ref_netG"))
    flags = list(CLI_FLAGS)
    flags[flags.index("--mc_backend") + 1] = "host"
    flags[flags.index("--mc_algorithm") + 1] = "tets"
    args = ["--dataroot", str(root), "--name", "ev",
            "--load_netG_checkpoint_path", ckpt, *flags]
    monkeypatch.setattr(sys, "argv", [
        "eval_surs.py", *args, "--results_path", str(tmp_path / "jax")])
    runpy.run_path(APP, run_name="__main__")
    main([*args, "--results_path", str(tmp_path / "torch"),
          "--device", "cpu"])
    capsys.readouterr()
    for suffix in ("_HR.obj", "_LR.obj"):
        vg, fg = load_obj(str(tmp_path / "torch" / "ev" / ("s" + suffix)))
        vw, fw = j_load_obj(str(tmp_path / "jax" / "ev" / ("s" + suffix)))
        assert fg.shape[0] > 0 and fg.shape == fw.shape
        assert vg.shape == vw.shape
        assert max(nearest_gap(vg, vw), nearest_gap(vw, vg)) < 1e-3


# ------------------------------------------------------------------ config --
@pytest.mark.parametrize("field,value", [
    ("mc_algorithm", "tets"), ("mc_algorithm", "cubes"),
    ("mc_backend", "host"), ("mc_backend", "device")])
def test_resolve_config_accepts_the_extractors(field, value):
    cfg = resolve_config(dataclasses.replace(SuRSConfig(), **{field: value}),
                         "cpu")
    assert getattr(cfg, field) == value


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_auto_extractor_is_the_device_cubes(device):
    """'auto' in the config takes the port's AUTO row on both devices:
    device marching cubes, the JAX package's TPU choice."""
    cfg = resolve_config(SuRSConfig(), device)
    assert (cfg.mc_backend, cfg.mc_algorithm) == ("device", "cubes")


def test_resolve_config_rejects_sharded_and_unknown():
    """mc_backend 'sharded' resolves since A13 was ported; an unknown
    value raises."""
    assert resolve_config(SuRSConfig(mc_backend="sharded"),
                          "cpu").mc_backend == "sharded"
    with pytest.raises(ValueError, match="mc_backend"):
        resolve_config(SuRSConfig(mc_backend="slabs"), "cpu")
    with pytest.raises(ValueError, match="mc_algorithm"):
        resolve_config(SuRSConfig(mc_algorithm="dual"), "cpu")
