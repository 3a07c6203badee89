"""The port's octree evaluator (surs_tpu_torch/recon/evaluator.py)
against the JAX mono evaluator and the reference-semantics numpy oracle,
on the analytic sphere fields. The coordinates are exact binary
fractions and the oracle thresholds them, so the fields must be exactly
equal."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from surs_tpu.recon.evaluator import eval_grid_octree_mono
from surs_tpu.recon.grid import grid_matrix as j_grid_matrix
from surs_tpu_torch.recon.evaluator import eval_grid_octree, level_schedule
from surs_tpu_torch.recon.grid import grid_matrix
from test_recon import binary_sphere_eval, oracle_octree

torch.set_num_threads(1)
CALIB = np.diag([2.0, -2.0, 2.0, 1.0]).astype(np.float32)[None]


def sphere_jax(points, ctx=None):
    r = jnp.linalg.norm(points, axis=0)
    return (r < 0.35).astype(jnp.float32), (r < 0.30).astype(jnp.float32)


def sphere_torch(points):
    r = torch.linalg.norm(points, dim=0)
    return (r < 0.35).float(), (r < 0.30).float()


def disc_mask(S=64, radius=0.39):
    yy, xx = np.mgrid[:S, :S]
    cc = (S - 1) / 2
    return ((((xx - cc) ** 2 + (yy - cc) ** 2) < (radius * S) ** 2)
            .astype(np.float32))


def test_grid_matrix_matches_jax():
    b = (np.array([-1.0, -2.0, 0.0]), np.array([1.0, 2.0, 4.0]))
    np.testing.assert_array_equal(grid_matrix((8, 16, 4), *b),
                                  j_grid_matrix((8, 16, 4), *b))


def test_level_schedule():
    assert level_schedule(512, 64) == [8, 4, 2, 1]
    with pytest.raises(ValueError):
        level_schedule(40, 8)      # strides 5, 2, 1: 2 does not divide 5


def test_matches_numpy_oracle():
    R, init, thr = 32, 8, 0.05
    mat = grid_matrix((R,) * 3, [-0.5] * 3, [0.5] * 3)
    ref_hr, ref_lr = oracle_octree(binary_sphere_eval, R, mat, thr, init)
    hr, lr = eval_grid_octree(sphere_torch, R, mat, thr,
                              init_resolution=init, num_samples=1000,
                              device="cpu")
    np.testing.assert_array_equal(hr.numpy(), ref_hr.astype(np.float32))
    np.testing.assert_array_equal(lr.numpy(), ref_lr.astype(np.float32))


@pytest.mark.parametrize("R,init", [(32, 8), (64, 16)])
@pytest.mark.parametrize("with_mask", [False, True])
def test_matches_jax_mono(R, init, with_mask):
    thr = 0.05
    mat = grid_matrix((R,) * 3, [-0.5] * 3, [0.5] * 3)
    kw_j, kw_t = {}, {}
    if with_mask:
        # a disc slightly smaller than the spheres' projection, so the
        # pruning visibly cuts the fields
        m = disc_mask(radius=0.3)
        kw_j = dict(silhouette=jnp.asarray(m), silhouette_calib=CALIB,
                    silhouette_dilate=2)
        kw_t = dict(silhouette=m, silhouette_calib=CALIB,
                    silhouette_dilate=2)
    want_hr, want_lr = eval_grid_octree_mono(
        sphere_jax, R, mat, thr, init_resolution=init, num_samples=1000,
        **kw_j)
    stats = {}
    hr, lr = eval_grid_octree(sphere_torch, R, mat, thr,
                              init_resolution=init, num_samples=1000,
                              stats=stats, device="cpu", **kw_t)
    np.testing.assert_array_equal(hr.numpy(), np.asarray(want_hr))
    np.testing.assert_array_equal(lr.numpy(), np.asarray(want_lr))
    assert 0 < stats["queries"] < R ** 3
    assert hr.numpy().sum() > 0


def test_mask_prunes_queries():
    R, init = 32, 8
    mat = grid_matrix((R,) * 3, [-0.5] * 3, [0.5] * 3)
    full, pruned = {}, {}
    eval_grid_octree(sphere_torch, R, mat, 0.05, init_resolution=init,
                     stats=full, device="cpu")
    eval_grid_octree(sphere_torch, R, mat, 0.05, init_resolution=init,
                     silhouette=disc_mask(), silhouette_calib=CALIB,
                     stats=pruned, device="cpu")
    assert pruned["queries"] < full["queries"]
