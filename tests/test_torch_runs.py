"""The port's runs-mode octree evaluator (surs_tpu_torch/recon/
evaluator_runs.py) against the JAX package's (XLA twin of the window
kernel) and against the port's own mono evaluator driven by the per-point
query (K1's plain version) on the same weights and feature maps, at
full MLP widths. Both comparisons at atol 2e-4, the tolerance of
tests/test_evaluator_runs.py: the window path feeds the depth as
kf + zt, the point path as one projected z, equal up to float32
rounding, and a rounding-level change of a value can move a prune
decision's (max + min) / 2 fill by that much."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from surs_tpu.models import SurfaceClassifier as FlaxSurfaceClassifier
from surs_tpu.ops.fused_mlp import prepare_fused_weights as j_prepare
from surs_tpu.recon import evaluator_runs as jer
from surs_tpu.recon.evaluator import silhouette_init_masks
from surs_tpu.recon.grid import grid_matrix as j_grid_matrix
from surs_tpu_torch.compat.flax_import import load_flax_params
from surs_tpu_torch.models.surface_classifier import SurfaceClassifier
from surs_tpu_torch.ops import fused_mlp as fm
from surs_tpu_torch.ops.point_query import fused_query
from surs_tpu_torch.recon.evaluator import eval_grid_octree
from surs_tpu_torch.recon.evaluator_runs import (eval_grid_octree_runs,
                                                 runs_supported)
from surs_tpu_torch.recon.grid import grid_matrix

torch.set_num_threads(1)
DIMS_LR = (321, 1024, 512, 256, 128, 1)
DIMS_HR = (322, 1024, 512, 256, 128, 1)
C_LR, C_HR = 256, 64
LOAD_SIZE, Z_SIZE = 32, 200.0
CALIB = np.diag([2.0, -2.0, 2.0, 1.0]).astype(np.float32)[None]
R, INIT, THRESHOLD = 32, 8, 0.1


def rotated_calib(th=0.3):
    rot = np.eye(4, dtype=np.float32)
    rot[0, 0], rot[0, 2] = np.cos(th), np.sin(th)
    rot[2, 0], rot[2, 2] = -np.sin(th), np.cos(th)
    return (rot @ CALIB[0])[None]


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(1234)
    p_lr = FlaxSurfaceClassifier(DIMS_LR).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 321)))["params"]
    p_hr = FlaxSurfaceClassifier(DIMS_HR).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 4, 322)))["params"]
    p_lr = jax.tree_util.tree_map(np.asarray, p_lr)
    p_hr = jax.tree_util.tree_map(np.asarray, p_hr)
    jfw = j_prepare(p_lr, p_hr, DIMS_LR, DIMS_HR, base_split=(C_LR, C_HR, 1))
    cw = fm.prepare_cols_weights(
        load_flax_params(SurfaceClassifier(DIMS_LR), p_lr),
        load_flax_params(SurfaceClassifier(DIMS_HR), p_hr), C_LR)
    feat_lr = (0.3 * rng.standard_normal((1, 16, 16, C_LR))).astype(
        np.float32)
    feat_hr = (0.3 * rng.standard_normal((1, 32, 32, C_HR))).astype(
        np.float32)
    return jfw, cw, feat_lr, feat_hr


def silhouette():
    m = np.zeros((24, 24), np.float32)
    m[4:18, 7:15] = 1.0
    return m


def port_runs(setup, nwin_chunk=32768, with_mask=False, stats=None):
    _, cw, feat_lr, feat_hr = setup
    mat = grid_matrix((R,) * 3, [-0.5] * 3, [0.5] * 3)
    return eval_grid_octree_runs(
        cw, torch.from_numpy(feat_lr), torch.from_numpy(feat_hr), CALIB, R,
        mat, THRESHOLD, LOAD_SIZE, Z_SIZE, init_resolution=INIT,
        nwin_chunk=nwin_chunk,
        silhouette=silhouette() if with_mask else None, silhouette_dilate=1,
        stats=stats)


@pytest.mark.parametrize("with_mask", [False, True])
def test_runs_matches_jax(setup, with_mask):
    jfw, _, feat_lr, feat_hr = setup
    mat = j_grid_matrix((R,) * 3, np.array([-0.5] * 3), np.array([0.5] * 3))
    init = None
    if with_mask:
        init = silhouette_init_masks(jnp.asarray(silhouette()), CALIB, R,
                                     mat, init_resolution=INIT, dilate=1)
    want = jer.eval_grid_octree_runs(
        jfw, jnp.asarray(feat_lr), jnp.asarray(feat_hr), jnp.asarray(CALIB),
        R, mat, THRESHOLD, LOAD_SIZE, Z_SIZE, init_resolution=INIT,
        nwin_chunk=64, run_block=2, use_pallas=False, init_dirty=init)
    got = port_runs(setup, with_mask=with_mask)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (R, R, R)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4)
    if with_mask:
        assert (got[0].numpy() == 0).any()       # the mask pruned voxels


@pytest.mark.parametrize("with_mask", [False, True])
def test_runs_matches_port_mono(setup, with_mask):
    _, cw, feat_lr, feat_hr = setup
    f_lr, f_hr = torch.from_numpy(feat_lr), torch.from_numpy(feat_hr)
    calib_t = torch.from_numpy(CALIB)

    def eval_fn(points):
        hr, lr = fused_query(cw.fw, f_lr, f_hr, points[None], calib_t,
                             LOAD_SIZE, Z_SIZE)
        return hr[0], lr[0]

    mono, runs = {}, {}
    mat = grid_matrix((R,) * 3, [-0.5] * 3, [0.5] * 3)
    want = eval_grid_octree(
        eval_fn, R, mat, THRESHOLD, init_resolution=INIT, num_samples=997,
        silhouette=silhouette() if with_mask else None,
        silhouette_calib=CALIB, silhouette_dilate=1, stats=mono,
        device="cpu")
    got = port_runs(setup, with_mask=with_mask, stats=runs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-4)
    # whole windows: at least as many points as the point path, at most 8x
    assert mono["queries"] <= runs["queries"] <= 8 * mono["queries"]
    assert runs["queries"] % 8 == 0


def test_several_window_chunks(setup):
    """Chunks of 7 windows (far below a level's window count) give the
    fields of one chunk per level."""
    one = port_runs(setup)
    many = port_runs(setup, nwin_chunk=7)
    for a, b in zip(many, one):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("calib,res,init,ok", [
    (CALIB, 32, 8, True),
    (rotated_calib(), 32, 8, False),      # z mixes into (u, v)
    (CALIB, 16, 4, False),                # init level below the window
    (CALIB, 40, 8, False),                # strides 5, 2, 1: 2 misses 5
    (CALIB, 512, 64, True)])
def test_runs_supported_gates(calib, res, init, ok):
    mat = grid_matrix((res,) * 3, [-0.5] * 3, [0.5] * 3)
    assert runs_supported(calib, mat, res, init) is ok
    assert jer.runs_supported(calib, mat, res, init) is ok


def test_unsupported_geometry_raises(setup):
    _, cw, feat_lr, feat_hr = setup
    mat = grid_matrix((R,) * 3, [-0.5] * 3, [0.5] * 3)
    with pytest.raises(ValueError, match="mono mode"):
        eval_grid_octree_runs(cw, torch.from_numpy(feat_lr),
                              torch.from_numpy(feat_hr), rotated_calib(), R,
                              mat, THRESHOLD, LOAD_SIZE, Z_SIZE,
                              init_resolution=INIT)


# ------------------------------------------------------ the service path --
SERVICE = dict(loadSize=32, num_stack_lr=1, resolution=32,
               octree_init_resolution=8, num_samples=4096,
               b_min=[-0.5] * 3, b_max=[0.5] * 3, mask_prune=True,
               dtype="float32", feature_dtype="float32", seed=2)


def subject(S=16):
    rng = np.random.default_rng(0)
    img = (rng.random((S, S, 3)) * 255).astype(np.uint8)
    yy, xx = np.mgrid[:S, :S]
    mask = ((((xx - S / 2) / (S * 0.3)) ** 2
             + ((yy - S / 2) / (S * 0.42)) ** 2) < 1).astype(np.uint8) * 255
    return img, mask


def test_runs_service_matches_mono_service(tmp_path):
    """SuRSService(serve_octree_mode='runs') on the CPU: K4's plain
    version scores dirty windows, the fields match the mono service's
    at atol 2e-4, and the OBJ pair is written and non-empty."""
    from surs_tpu_torch.config import SuRSConfig
    from surs_tpu_torch.serve import SuRSService
    img, mask = subject()
    runs = SuRSService(SuRSConfig(serve_octree_mode="runs", **SERVICE),
                       device="cpu")
    mono = SuRSService(SuRSConfig(**SERVICE), device="cpu")
    st_r, st_m = {}, {}
    got = runs.fields(img, mask, stats=st_r)
    want = mono.fields(img, mask, stats=st_m)
    assert (st_r["mode"], st_m["mode"]) == ("octree-runs", "octree-mono")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-4)
    for path in runs.reconstruct(img, mask, "subj", str(tmp_path)):
        assert path.endswith(".obj")
        assert open(path).read().count("\nf ") > 0


def test_runs_falls_back_to_mono_off_its_geometry():
    """A rotated calibration is not column-separable: the runs service
    evaluates through the mono octree (K1), and says so."""
    from surs_tpu_torch.config import SuRSConfig
    from surs_tpu_torch.serve import SuRSService
    svc = SuRSService(SuRSConfig(serve_octree_mode="runs", **SERVICE),
                      device="cpu")
    img, mask = subject()
    data = svc._data(img, mask)
    _, feats_lr, feat_hr = svc.rec.encode(data["img_LR"])
    for calib, mode in ((CALIB, "octree-runs"),
                        (rotated_calib(), "octree-mono")):
        stats = {}
        hr, _, _ = svc.rec.evaluate(feats_lr, feat_hr, calib, 32,
                                    SERVICE["b_min"], SERVICE["b_max"],
                                    init_resolution=8, stats=stats)
        assert stats["mode"] == mode and tuple(hr.shape) == (32, 32, 32)
