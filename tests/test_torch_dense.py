"""The port's dense evaluators (surs_tpu_torch/recon/evaluator.py) against
the JAX package's on features of a small encoded SuRSNet (loadSize 32,
2 lr stacks, full-width MLPs), as tests/test_recon.py:662-703:
the column-shared evaluator (K3's plain version) against JAX's
``eval_grid_dense_cols`` (its XLA twin) and the generic per-point
evaluator (K1's plain version) against JAX's ``eval_grid_dense``, both
float32 at atol 1e-5 (the same float32 products in another summation
order, through bilinear gathers of the same maps). Also the separability
test and the Reconstructor's dispatch: a rotated calibration falls back
to the generic dense path, and ``stats["mode"]`` says which ran."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from surs_tpu.models import SuRSNet as JSuRSNet
from surs_tpu.ops.fused_mlp import prepare_fused_weights as j_prepare
from surs_tpu.recon import evaluator as jev
from surs_tpu.recon.grid import flat_index_to_world as j_flat_index_to_world
from surs_tpu.recon.pipeline import Reconstructor as JReconstructor
from surs_tpu_torch.compat.flax_import import load_flax_params
from surs_tpu_torch.models.surs_net import SuRSNet
from surs_tpu_torch.ops.fused_mlp import (prepare_cols_weights,
                                          prepare_fused_weights)
from surs_tpu_torch.ops.point_query import fused_query
from surs_tpu_torch.recon.evaluator import (dense_cols_separable,
                                            eval_grid_dense,
                                            eval_grid_dense_cols)
from surs_tpu_torch.recon.grid import flat_index_to_world, grid_matrix
from surs_tpu_torch.recon.pipeline import Reconstructor

torch.set_num_threads(1)
DIMS_LR = (321, 1024, 512, 256, 128, 1)
DIMS_HR = (322, 1024, 512, 256, 128, 1)
R = 16
B_MIN, B_MAX = np.array([-0.6, -0.5, -0.4]), np.array([0.5, 0.6, 0.7])
CALIB = np.diag([2.0, -2.0, 2.0, 1.0]).astype(np.float32)[None]


def rotated_calib(deg=30.0):
    th = np.deg2rad(deg)
    rot = np.eye(4, dtype=np.float32)
    rot[0, 0] = rot[2, 2] = np.cos(th)
    rot[0, 2] = np.sin(th)
    rot[2, 0] = -np.sin(th)
    return (CALIB[0] @ rot)[None]


@pytest.fixture(scope="module")
def net():
    """JAX params of a small SuRSNet, its encoded features, and the port's
    model and weights through the bridge."""
    model = JSuRSNet(load_size=32, num_stack_lr=2)
    S = 16
    rng = np.random.default_rng(5)
    img = jnp.asarray(rng.standard_normal((1, S, S, 3)).astype(np.float32))
    img_hr = jnp.asarray(
        rng.standard_normal((1, 2 * S, 2 * S, 3)).astype(np.float32))
    pts0 = jnp.asarray((rng.random((1, 3, 4)) - 0.5).astype(np.float32))
    params = model.init(jax.random.PRNGKey(0), img, img_hr, pts0, pts0,
                        jnp.asarray(CALIB), train=True)["params"]
    jrec = JReconstructor(model)
    _, feats_lr, feat_hr = jrec.encode(params, img)
    tmodel = SuRSNet(num_stack_lr=2, load_size=32)
    load_flax_params(tmodel, jax.tree_util.tree_map(np.asarray, params))
    trec = Reconstructor(
        tmodel.eval(), prepare_fused_weights(tmodel.mlp_lr, tmodel.mlp_hr),
        "cpu", cols_weights=prepare_cols_weights(tmodel.mlp_lr,
                                                 tmodel.mlp_hr, 256))
    return dict(model=model, params=params, jrec=jrec,
                feats_lr=feats_lr, feat_hr=feat_hr, trec=trec,
                t_lr=torch.from_numpy(np.array(feats_lr[-1])),
                t_hr=torch.from_numpy(np.array(feat_hr)))


def test_flat_index_to_world_matches_jax():
    mat = grid_matrix((R,) * 3, B_MIN, B_MAX)
    idx = np.arange(0, R ** 3, 7, dtype=np.int32)
    got = flat_index_to_world(torch.from_numpy(idx).long(), R, 2, mat)
    want = j_flat_index_to_world(jnp.asarray(idx), R, 2, mat)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dense_cols_matches_jax(net):
    mat = grid_matrix((R,) * 3, B_MIN, B_MAX)
    jfw = j_prepare(net["params"]["mlp_lr"], net["params"]["mlp_hr"],
                    DIMS_LR, DIMS_HR, base_split=(256, 64, 1))
    want = jev.eval_grid_dense_cols(jfw, net["feats_lr"][-1],
                                    net["feat_hr"], CALIB, R, mat, 32, 200.0,
                                    use_pallas=False)
    got = eval_grid_dense_cols(net["trec"].cols_weights, net["t_lr"],
                               net["t_hr"], CALIB, R, mat, 32, 200.0)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (R, R, R)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)
    assert (got[0].numpy() == 0).any()      # columns outside the image


def test_dense_generic_matches_jax(net):
    """num_samples=500 leaves a tail chunk (4096 = 8 x 500 + 96)."""
    want_hr, want_lr, _ = net["jrec"].evaluate(
        net["params"], net["feats_lr"], net["feat_hr"], CALIB, R, B_MIN,
        B_MAX, use_octree=False, num_samples=500)
    fw = net["trec"].weights
    calib_t = torch.from_numpy(CALIB)

    def eval_fn(points):
        hr, lr = fused_query(fw, net["t_lr"], net["t_hr"], points[None],
                             calib_t, 32, 200.0)
        return hr[0], lr[0]

    mat = grid_matrix((R,) * 3, B_MIN, B_MAX)
    got = eval_grid_dense(eval_fn, R, mat, num_samples=500, device="cpu")
    for g, w in zip(got, (want_hr, want_lr)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)


def test_reconstructor_dense_cols_equals_generic_dense(net):
    """The two dense paths of the port's Reconstructor agree (rtol 1e-4,
    atol 1e-5 as in the JAX package's test): the column path rounds
    nothing in float32, only its sums run in another order."""
    feats = ([net["t_lr"]], net["t_hr"])
    st_c, st_d = {}, {}
    got = net["trec"].evaluate(*feats, CALIB, R, B_MIN, B_MAX,
                               use_octree=False, num_samples=500,
                               stats=st_c)
    plain = Reconstructor(net["trec"].model, net["trec"].weights, "cpu")
    want = plain.evaluate(*feats, CALIB, R, B_MIN, B_MAX, use_octree=False,
                          num_samples=500, stats=st_d)
    assert (st_c["mode"], st_d["mode"]) == ("dense-cols", "dense")
    assert st_c["queries"] == st_d["queries"] == R ** 3
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("calib,separable", [
    (CALIB, True),
    (rotated_calib(), False),              # z mixes into (u, v)
    (np.diag([1.5, -2.0, 0.5, 1.0]).astype(np.float32)[None], True),
    (rotated_calib(90.0), False)])
def test_dense_cols_separable(calib, separable):
    mat = grid_matrix((R,) * 3, B_MIN, B_MAX)
    assert dense_cols_separable(calib, mat) is separable
    assert jev.dense_cols_separable(calib, mat) is separable


def test_rotated_calibration_takes_generic_dense(net):
    feats = ([net["t_lr"]], net["t_hr"])
    calib = rotated_calib()
    stats = {}
    got = net["trec"].evaluate(*feats, calib, R, B_MIN, B_MAX,
                               use_octree=False, num_samples=500,
                               stats=stats)
    assert stats["mode"] == "dense"
    want_hr, _, _ = net["jrec"].evaluate(
        net["params"], net["feats_lr"], net["feat_hr"], calib, R, B_MIN,
        B_MAX, use_octree=False, num_samples=500)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want_hr),
                               rtol=0, atol=1e-5)


def test_dense_service_writes_obj_pair(tmp_path):
    """SuRSService(use_octree=False) on the CPU: every grid point is
    scored (K3's plain version), the OBJ pair is written and non-empty."""
    from surs_tpu_torch.config import SuRSConfig
    from surs_tpu_torch.serve import SuRSService
    cfg = SuRSConfig(loadSize=32, num_stack_lr=1, resolution=32,
                     b_min=[-0.5] * 3, b_max=[0.5] * 3, use_octree=False,
                     seed=2)
    svc = SuRSService(cfg, device="cpu")
    S = 16
    rng = np.random.default_rng(0)
    img = (rng.random((S, S, 3)) * 255).astype(np.uint8)
    stats = {}
    hr, lr = svc.fields(img, None, stats=stats)
    # the host waits: the calibration's copy and two affines of two terms
    assert stats.pop("sync_wait_s") >= 0.0
    assert stats == {"mode": "dense-cols", "queries": 32 ** 3, "syncs": 5}
    assert tuple(hr.shape) == (32, 32, 32) and bool(torch.isfinite(lr).all())
    for path in svc.reconstruct(img, None, "subj", str(tmp_path)):
        assert open(path).read().count("\nf ") > 0
