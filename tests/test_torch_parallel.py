"""The port's multi-device paths (surs_tpu_torch/parallel/) against the
JAX package's (surs_tpu/parallel/ on the 8-device virtual CPU mesh of
tests/conftest.py), on the CPU with the same weights through the Flax
bridge and the same numpy inputs.

In process, with no process group, the port's ranks run as threads of
this process (``launch.run_threads``, ``comm.ThreadComm``), one a shard
coordinate, 8 of them:

* the column-sharded dense evaluator against JAX's at R = 16 (atol
  1e-5, float32 in another summation order);
* the slab-sharded extraction (a sphere across slab boundaries and a
  noise field, cubes and tets, R = 32, and the empty field): equal to the
  port's single-device march array for array, and to JAX's sharded
  extractor as a mesh: the same faces over vertices matched within 1e-5
  (JAX interpolates in float32, the port in float64, so a vertex now and
  then rounds to the other side of a 1/4096 grid line);
* ``extract_pair``'s 'sharded' backend against JAX's, the same way
  (within 1e-4 of a grid step, through world coordinates);
  ``reconstruct_subject_sharded`` (R = 32) against the port's
  single-device dense path as sets and against JAX's by counts and
  vertices within 2e-4 (its fields 1e-5 apart);
* ``Reconstructor(point_mesh=)`` against JAX's (R = 16, rtol 1e-4, atol
  1e-5) and ``ShardedReconstructor`` against tests/test_batch_recon.py's
  per-subject spheres (atol 1e-6);
* the data-parallel step, group norm and batch norm, against JAX's step
  on ``make_mesh(n_data=8)``: the losses at rtol 1e-4, the update as
  tests/test_torch_configs.py's ``assert_step_close`` (each tensor
  within max(STEP_TOL, 2 x the port's own spread), the batch statistics
  at rtol / atol 1e-4), every rank's state the same.

Then one gloo group of 4 processes (``launch.spawn``) runs every part of
``parallel/checks.py`` (the broadcast of the weights, the halo, the slab
merge, the gathers, the gradient and batch-statistics sums), and its
results equal the same parts run as 4 threads bit for bit, but for the
step: gloo's ``all_reduce`` sums in its own order, the threads in rank
order, so the step's losses, update and batch statistics agree to
float32 rounding (``SUM_ORDER_TOL``) and every gloo rank holds the same
bits. Also: the
eval CLI with ``--mc_backend sharded`` in one process, and NCCL or a
CUDA mesh without a card raising.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.spatial import cKDTree

from surs_tpu.models import SuRSNet as JSuRSNet
from surs_tpu.ops.fused_mlp import prepare_fused_weights as j_prepare
from surs_tpu.parallel import batch_sharding as j_batch_sharding
from surs_tpu.parallel import extract_isosurface_sharded as j_extract
from surs_tpu.parallel import make_mesh as j_make_mesh
from surs_tpu.parallel import reconstruct_subject_sharded as j_subject
from surs_tpu.parallel import replicate_tree as j_replicate
from surs_tpu.parallel.batch_recon import \
    ShardedReconstructor as JShardedReconstructor
from surs_tpu.recon import evaluator as jev
from surs_tpu.recon.pipeline import Reconstructor as JReconstructor
from surs_tpu.train.step import TrainState as JTrainState
from surs_tpu.train.step import make_train_step as j_make_train_step
from surs_tpu_torch.config import SuRSConfig, resolve_config
from surs_tpu_torch.compat.flax_import import load_flax_params
from surs_tpu_torch.models.surs_net import SuRSNet
from surs_tpu_torch.ops.fused_mlp import (prepare_cols_weights,
                                          prepare_fused_weights)
from surs_tpu_torch.parallel import (DATA_AXIS, POINT_AXIS,
                                     ShardedReconstructor, batch_sharding,
                                     checks, extract_isosurface_sharded,
                                     make_mesh, point_sharding,
                                     reconstruct_subject_sharded, shard,
                                     shard_batch)
from surs_tpu_torch.parallel.launch import run_threads, spawn
from surs_tpu_torch.parallel.sharded_mc import gather_field
from surs_tpu_torch.recon.evaluator import (eval_grid_dense_cols,
                                            eval_grid_dense_cols_sharded)
from surs_tpu_torch.recon.grid import grid_matrix
from surs_tpu_torch.recon.marching import CapacityError, marching_cubes
from surs_tpu_torch.recon.pipeline import Reconstructor
from surs_tpu_torch.recon.tetra import marching_tetrahedra
from test_batch_recon import per_subject_sphere_eval
from test_parallel import _sphere_vol
from test_torch_configs import (CALIB, assert_step_close, make_batch,
                                port_net, seeded_variables, step_spread,
                                to_jax, to_numpy, to_torch)

torch.set_num_threads(1)
N = 8                                   # shard coordinates in process
B_MIN, B_MAX = np.array([-0.5] * 3), np.array([0.5] * 3)
GAP = 1e-5                              # float32 vs float64 vertices
DIMS_LR = (321, 1024, 512, 256, 128, 1)
DIMS_HR = (322, 1024, 512, 256, 128, 1)


@pytest.fixture(scope="module")
def net():
    """A small SuRSNet's seeded Flax params (traced shapes, no compile),
    the port's model on them through the bridge, and seeded feature maps
    (lr [1, 8, 8, 256], hr [1, 16, 16, 64]): the evaluators under test
    take the maps whatever made them."""
    model = JSuRSNet(load_size=32, num_stack_lr=1)
    params = seeded_variables(model, train=True,
                              **to_jax(make_batch(rows=1)))["params"]
    rng = np.random.default_rng(5)
    f_lr = rng.standard_normal((1, 8, 8, 256)).astype(np.float32)
    f_hr = rng.standard_normal((1, 16, 16, 64)).astype(np.float32)
    tmodel = load_flax_params(SuRSNet(load_size=32, num_stack_lr=1),
                              params).eval()
    trec = Reconstructor(
        tmodel, prepare_fused_weights(tmodel.mlp_lr, tmodel.mlp_hr), "cpu",
        cols_weights=prepare_cols_weights(tmodel.mlp_lr, tmodel.mlp_hr, 256))
    return dict(model=model, params=jax.tree_util.tree_map(jnp.asarray,
                                                           params),
                feats_lr=[jnp.asarray(f_lr)], feat_hr=jnp.asarray(f_hr),
                trec=trec, t_lr=torch.from_numpy(f_lr),
                t_hr=torch.from_numpy(f_hr))


def noise_vol():
    return np.random.default_rng(5).normal(0.5, 0.4, (32, 32, 32)).astype(
        np.float32)


def fields():
    return {"sphere": _sphere_vol(32, (15.3, 16.2, 14.9), 11.5),
            "noise": noise_vol()}


def canon(verts, faces):
    """A mesh as sets (tests/test_parallel.py's ``_canon_mesh``,
    vectorised): the sorted vertex keys (grid coordinates quantised to
    1/4096, 21 bits an axis) and the faces as key triples rotated to
    their smallest key (winding kept), in lexicographic order."""
    q = np.rint(np.asarray(verts, np.float64) * 4096.0).astype(np.int64)
    assert q.size == 0 or (q.min() >= 0 and q.max() < 1 << 21)
    key = (q[:, 0] << 42) | (q[:, 1] << 21) | q[:, 2]
    fk = key[np.asarray(faces, np.int64)].reshape(-1, 3)
    rot = np.argmin(fk, axis=1)
    fk = fk[np.arange(len(fk))[:, None], (rot[:, None] + np.arange(3)) % 3]
    return np.sort(key), fk[np.lexsort(fk.T[::-1])]


def assert_same_sets(va, fa, vb, fb):
    """The same quantised vertex set and winding-preserving face set."""
    assert va.shape == vb.shape and fa.shape == fb.shape
    for x, y in zip(canon(va, fa), canon(vb, fb)):
        np.testing.assert_array_equal(x, y)


def assert_same_as_jax(vg, fg, vw, fw, gap=GAP):
    """The same mesh: every vertex matched one to one within ``gap`` and
    the same faces, windings kept, over the matching."""
    vg, vw = np.asarray(vg, np.float64), np.asarray(vw, np.float64)
    fw = np.asarray(fw)
    assert vg.shape == vw.shape and fg.shape == fw.shape
    if len(vg) == 0:
        return
    d, match = cKDTree(vw).query(vg)
    assert d.max() <= gap and len(np.unique(match)) == len(vg)
    np.testing.assert_array_equal(canon(vw, match[fg])[1], canon(vw, fw)[1])


# ------------------------------------------------------------------ mesh ---
def test_mesh_shapes_and_sharding():
    one = make_mesh()
    assert one.shape == {DATA_AXIS: 1, POINT_AXIS: 1} and one.is_root
    with pytest.raises(ValueError, match="needs a process group"):
        make_mesh(n_data=4, n_points=2)
    meshes = run_threads(lambda m: m, 8, n_points=2)
    assert [m.coords for m in meshes[:3]] == [
        {DATA_AXIS: 0, POINT_AXIS: 0}, {DATA_AXIS: 0, POINT_AXIS: 1},
        {DATA_AXIS: 1, POINT_AXIS: 0}]
    assert meshes[5].shape == {DATA_AXIS: 4, POINT_AXIS: 2}
    x = torch.arange(8 * 6.0).reshape(8, 2, 3)
    m = meshes[5]                              # data 2 of 4, points 1 of 2
    assert torch.equal(shard(x, batch_sharding(m, 3)), x[4:6])
    assert torch.equal(shard(x, point_sharding(m, 1, 3)), x[:, 1:2])
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch({"x": torch.zeros(6, 2)}, meshes[0])


# ----------------------------------------------------------------- dense ---
def test_dense_cols_sharded_matches_jax(net):
    R = 16
    mat = grid_matrix((R,) * 3, B_MIN, B_MAX)
    jfw = j_prepare(net["params"]["mlp_lr"], net["params"]["mlp_hr"],
                    DIMS_LR, DIMS_HR, base_split=(256, 64, 1))
    want = jev.eval_grid_dense_cols_sharded(
        jfw, net["feats_lr"][-1], net["feat_hr"], CALIB[None], R, mat, 32,
        200.0, j_make_mesh(n_data=1, n_points=N), use_pallas=False)
    cw = net["trec"].cols_weights
    slabs = run_threads(lambda m: eval_grid_dense_cols_sharded(
        cw, net["t_lr"], net["t_hr"], CALIB[None], R, mat, 32, 200.0, m),
        N, n_points=N)
    assert tuple(slabs[3][0].shape) == (R // N, R, R)
    for i in range(2):
        got = torch.cat([s[i] for s in slabs]).numpy()
        np.testing.assert_allclose(got, np.asarray(want[i]), rtol=0,
                                   atol=1e-5)
    whole = run_threads(lambda m: gather_field(eval_grid_dense_cols_sharded(
        cw, net["t_lr"], net["t_hr"], CALIB[None], R, mat, 32, 200.0, m)[0],
        m), 4, n_points=4)
    assert all(torch.equal(w, torch.cat([s[0] for s in slabs]))
               for w in whole)
    with pytest.raises(ValueError, match="divisible"):
        run_threads(lambda m: eval_grid_dense_cols_sharded(
            cw, net["t_lr"], net["t_hr"], CALIB[None], 12, mat, 32, 200.0,
            m), N, n_points=N)


# ------------------------------------------------------------ extraction ---
def extract_threads(vol, n=N, **kw):
    out = run_threads(lambda m: extract_isosurface_sharded(vol, 0.5, mesh=m,
                                                           **kw), n,
                      n_points=n)
    assert all(o is None for o in out[1:])
    return out[0]


@pytest.mark.parametrize("algorithm", ["cubes", "tets"])
def test_sharded_extraction_matches_single_and_jax(algorithm):
    ext = marching_cubes if algorithm == "cubes" else marching_tetrahedra
    mesh = j_make_mesh(n_data=1, n_points=N)
    for name, vol in fields().items():
        vs, fs = extract_threads(vol, algorithm=algorithm, cell_chunk=1 << 10)
        vd, fd = ext(torch.from_numpy(vol), 0.5)
        # the port's single-device march: the same arrays, vertex for
        # vertex (both in edge-key order), and the same face set
        np.testing.assert_array_equal(vs, vd.numpy(), err_msg=name)
        assert_same_sets(vs, fs, vd.numpy(), fd.numpy())
        vj, fj = j_extract(vol, 0.5, mesh=mesh, axis="points",
                           algorithm=algorithm, cell_chunk=1 << 10)
        assert_same_as_jax(vs, fs, vj, fj)


def test_sharded_extraction_empty_field_and_errors():
    vol = np.zeros((32, 32, 32), np.float32)
    vs, fs = extract_threads(vol)
    assert vs.shape == (0, 3) and fs.shape == (0, 3)
    vol = fields()["sphere"]
    with pytest.raises(ValueError, match="sharded extraction needs"):
        extract_threads(vol[:24, :, :], n=4)         # X/n = 6
    with pytest.raises(ValueError, match="max_cells_shard"):
        extract_threads(vol, max_cells_shard=64)
    with pytest.raises(CapacityError, match="tris"):
        extract_threads(vol, max_tris_shard=64)


# the JAX package's packed faces hold 21-bit vertex indices: it refuses
# a slab of more than 2^21 / 3 crossing points for cubes
JAX_SLAB_POINTS = (1 << 21) // 3


def test_sharded_extraction_past_the_jax_21_bit_bound():
    """A random-sign 96^3 field: its one slab at world size 1 holds more
    crossing points than the JAX package's 21-bit face format takes (a
    point crossing on one of its three +axis edges), and the port
    extracts it equal to the single-device march."""
    vol = np.random.default_rng(6).choice(
        np.array([0.0, 1.0], np.float32), (96, 96, 96))
    side = vol > 0.5
    crossing = np.zeros_like(side)
    crossing[:-1] |= side[:-1] != side[1:]
    crossing[:, :-1] |= side[:, :-1] != side[:, 1:]
    crossing[:, :, :-1] |= side[:, :, :-1] != side[:, :, 1:]
    assert crossing.sum() > JAX_SLAB_POINTS
    vs, fs = extract_threads(vol, n=1)
    vd, fd = marching_cubes(torch.from_numpy(vol), 0.5)
    np.testing.assert_array_equal(vs, vd.numpy())
    assert_same_sets(vs, fs, vd.numpy(), fd.numpy())


def test_extract_pair_sharded_matches_jax():
    mat = np.diag([2.0 / 31, 2.0 / 31, 2.0 / 31, 1.0]).astype(np.float32)
    mat[:3, 3] = -1.0
    sdf_hr = _sphere_vol(32, (15.3, 16.2, 14.9), 11.5)
    sdf_lr = _sphere_vol(32, (16.0, 15.5, 16.5), 9.0)
    caps = {"axis": "points", "algorithm": "tets", "cell_chunk": 1 << 10}
    want = list(JReconstructor.extract_pair(
        sdf_hr, sdf_lr, mat, mc_backend="sharded",
        mc_caps={**caps, "mesh": j_make_mesh(n_data=1, n_points=N)}))

    def pair(m):
        stats = {}
        got = list(Reconstructor.extract_pair(
            torch.from_numpy(sdf_hr), torch.from_numpy(sdf_lr), mat,
            mc_backend="sharded", mc_caps={**caps, "mesh": m}, stats=stats))
        return got, stats

    out = run_threads(pair, N, n_points=N)
    assert all(o[0] == [None, None] for o in out[1:])
    got, stats = out[0]
    assert stats["mc"] == "sharded/tets"
    for (vs, fs), (vw, fw) in zip(got, want):
        assert vs.dtype == np.float32 and fs.shape[0] > 0
        # world coordinates: compare on the grid's own scale
        assert_same_as_jax((vs + 1) * 15.5, fs, (np.asarray(vw) + 1) * 15.5,
                           fw, gap=1e-4)


# ----------------------------------------------------------- one subject ---
def test_reconstruct_subject_sharded_matches_jax(net):
    """Against the port's single-device dense path (eval_grid_dense_cols
    then marching cubes) as sets, as tests/test_parallel.py holds JAX's;
    against JAX's sharded subject (fields 1e-5 apart: float32 in another
    order) by counts and vertices within 2e-4, as
    tests/test_torch_pipeline.py holds the served meshes."""
    R = 32
    jfw = j_prepare(net["params"]["mlp_lr"], net["params"]["mlp_hr"],
                    DIMS_LR, DIMS_HR, base_split=(256, 64, 1))
    want = j_subject(jfw, net["feats_lr"][-1], net["feat_hr"], CALIB[None],
                     R, B_MIN, B_MAX, 32, 200.0,
                     j_make_mesh(n_data=1, n_points=N), cell_chunk=1 << 10,
                     use_pallas=False)
    cw = net["trec"].cols_weights
    out = run_threads(lambda m: reconstruct_subject_sharded(
        cw, net["t_lr"], net["t_hr"], CALIB[None], R, B_MIN, B_MAX, 32,
        200.0, m, cell_chunk=1 << 10), N, n_points=N)
    assert all(o is None for o in out[1:])
    got = out[0]
    mat = grid_matrix((R,) * 3, B_MIN, B_MAX)
    single = eval_grid_dense_cols(cw, net["t_lr"], net["t_hr"], CALIB[None],
                                  R, mat, 32, 200.0)
    scale = R / (B_MAX - B_MIN)
    for i, sdf in zip((0, 2), single):
        vs, fs = got[i], got[i + 1]
        assert fs.shape[0] > 0
        vd, fd = marching_cubes(sdf, 0.5)
        vd = (vd.numpy() @ mat[:3, :3].T + mat[:3, 3]).astype(np.float32)
        assert_same_sets((vs - B_MIN) * scale, fs, (vd - B_MIN) * scale,
                         fd.numpy())
        vw, fw = np.asarray(want[i]), np.asarray(want[i + 1])
        assert vs.shape == vw.shape and fs.shape == fw.shape
        assert max(cKDTree(vw).query(vs)[0].max(),
                   cKDTree(vs).query(vw)[0].max()) < 2e-4


def test_point_sharded_reconstructor_matches_jax(net):
    R = 16
    kw = dict(num_samples=256, threshold=0.05, init_resolution=8)
    want = JReconstructor(net["model"], point_mesh=j_make_mesh(
        n_data=1, n_points=N)).evaluate(
        net["params"], net["feats_lr"], net["feat_hr"], CALIB[None], R,
        B_MIN, B_MAX, **kw)
    tmodel = net["trec"].model
    fw = prepare_fused_weights(tmodel.mlp_lr, tmodel.mlp_hr)

    def evaluate(m, num_samples=256):
        rec = Reconstructor(tmodel, fw, "cpu", point_mesh=m)
        return rec.evaluate([net["t_lr"]], net["t_hr"], CALIB[None], R,
                            B_MIN, B_MAX, **{**kw, "num_samples":
                                             num_samples})[:2]

    out = run_threads(evaluate, N, n_points=N)
    for got in out:
        for g, w in zip(got, want[:2]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                       atol=1e-5)
    assert all(torch.equal(o[0], out[0][0]) for o in out)   # replicated
    with pytest.raises(ValueError, match="num_samples"):
        run_threads(evaluate, N, n_points=N, args=(250,))


# ----------------------------------------------------------- B subjects ---
def test_sharded_reconstructor_matches_jax_spheres():
    R, thr, init_res = 16, 0.05, 8
    radii = np.linspace(0.15, 0.45, N).astype(np.float32)
    jrec = JShardedReconstructor(per_subject_sphere_eval,
                                 j_make_mesh(n_data=N, n_points=1), R,
                                 B_MIN, B_MAX, threshold=thr,
                                 init_resolution=init_res, num_samples=256)
    want_hr, want_lr = jrec.evaluate({"radius": jnp.asarray(radii)})

    def sphere(points, ctx):
        r = torch.linalg.vector_norm(points, dim=0)
        return ((r < ctx["radius"]).float(),
                (r < ctx["radius"] * 0.8).float())

    def work(m):
        srec = ShardedReconstructor(sphere, m, R, B_MIN, B_MAX,
                                    threshold=thr, init_resolution=init_res,
                                    num_samples=256)
        ctx = {"radius": torch.from_numpy(radii)}
        return srec.evaluate(ctx, gather=True), srec.reconstruct(ctx)

    out = run_threads(work, N)
    (hr, lr), meshes = out[0]
    assert tuple(hr.shape) == (N, R, R, R)
    np.testing.assert_allclose(hr.numpy(), np.asarray(want_hr), atol=1e-6)
    np.testing.assert_allclose(lr.numpy(), np.asarray(want_lr), atol=1e-6)
    assert all(o[1] is None for o in out[1:]) and len(meshes) == N
    vh, fh, vl, fl = meshes[5]
    assert fh.shape[0] > 0 and fl.shape[0] > 0
    assert abs(np.linalg.norm(vh, axis=1).mean() - radii[5]) < 0.05
    assert abs(np.linalg.norm(vl, axis=1).mean() - 0.8 * radii[5]) < 0.05


# ---------------------------------------------------------- data parallel ---
def jax_dp_step(norm):
    """JAX's step with the batch sharded over 8 devices (data) and the
    state replicated, from ``seeded_variables``; SGD(1.0)."""
    batch = make_batch(seed=7, rows=N)
    model = JSuRSNet(load_size=32, num_stack_lr=1, norm=norm)
    opt = optax.sgd(1.0)
    v = jax.tree_util.tree_map(jnp.asarray, seeded_variables(
        model, train=True, **to_jax(batch)))
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                        opt_state=opt.init(v["params"]),
                        batch_stats=v.get("batch_stats"))
    mesh = j_make_mesh(n_data=N, n_points=1)
    sharded = {k: jax.device_put(x, j_batch_sharding(mesh, x.ndim))
               for k, x in to_jax(batch).items()}
    new, metrics = j_make_train_step(model, opt, donate=False)(
        j_replicate(state, mesh), sharded)
    return state, batch, new, to_numpy(metrics)


@pytest.mark.parametrize("norm", ["group", "batch"])
def test_data_parallel_step_matches_jax(norm):
    from surs_tpu_torch.train import optim
    from surs_tpu_torch.train.step import create_train_state, make_train_step
    state, batch, new, want = jax_dp_step(norm)
    sgd = SuRSConfig(optimizer="SGD", momentum=0.0, learning_rate=1.0)

    def step(m):
        net = port_net(state)
        st = create_train_state(net, optim.make_optimizer(
            sgd, net.parameters()))
        st, metrics = make_train_step(net, st.optimizer, mesh=m)(
            st, shard_batch(to_torch(batch), m))
        return metrics, {k: v.clone() for k, v in net.state_dict().items()}

    out = run_threads(step, N)
    metrics, sd = out[0]
    np.testing.assert_allclose(metrics["total"].item(), float(want["total"]),
                               rtol=1e-4)
    for k in ("mlp1", "mlp2", "sr", "disp"):
        np.testing.assert_allclose(metrics[k].item(), float(want[k]),
                                   rtol=1e-4, err_msg=k)
    assert tuple(metrics["pred_hr"].shape) == (1,) + want["pred_hr"].shape[1:]
    for m, s in out[1:]:                    # every rank: the same state
        assert m["total"].item() == metrics["total"].item()
        assert all(torch.equal(s[k], sd[k]) for k in sd)
    # the update per tensor within max(STEP_TOL, 2 x the port's own
    # spread) of JAX's, the statistics at MODEL (test_torch_configs.py)
    before = port_net(state).state_dict()
    assert_step_close(before, sd, new, step_spread(state, batch))


def test_data_parallel_batch_must_divide():
    batch = to_torch(make_batch(seed=7, rows=6))
    with pytest.raises(ValueError, match="does not divide"):
        run_threads(lambda m: shard_batch(batch, m), 4)


# -------------------------------------------------------- a gloo group ---
TINY = dict(loadSize=32, num_stack_lr=1, resolution=32,
            octree_init_resolution=8, num_samples=4096, b_min=[-0.5] * 3,
            b_max=[0.5] * 3, dtype="float32", feature_dtype="float32",
            seed=2, optimizer="SGD", momentum=0.0, learning_rate=1.0)


def tiny_spec(parts):
    rng = np.random.default_rng(0)
    return dict(cfg=TINY, step_cfg={"norm": "batch"}, parts=parts,
                return_fields=True,
                return_params=True,
                image=(rng.standard_normal((1, 16, 16, 3)) * 0.5).astype(
                    np.float32),
                images=(rng.standard_normal((4, 16, 16, 3)) * 0.5).astype(
                    np.float32),
                batch=make_batch(seed=3, rows=4))


# gloo's all_reduce against a rank-order sum of 4 float32 tensors: the
# update's relative norm 9.2e-7, a statistic's 3.9e-7, a loss 8.3e-8
SUM_ORDER_TOL = 1e-5


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_gloo_group_equals_threads(tmp_path):
    """Every collective of the slice through a real process group: 4
    gloo ranks (all on ``points`` for the dense subject and the point
    octree, all on ``data`` for the subjects and the batch-norm step)
    against 4 threads, bit for bit but for the step's sums (module
    doc)."""
    spec = tiny_spec(["dense", "octree", "batch", "step"])
    procs = spawn(checks.run, 4, backend="gloo", device="cpu",
                  args=(spec,), n_points=4, store_dir=str(tmp_path))
    points = run_threads(checks.run, 4, n_points=4,
                         args=({**spec, "parts": ["dense", "octree"]},))
    data = run_threads(checks.run, 4, args=({**spec,
                                             "parts": ["batch", "step"]},))
    assert [p["rank"] for p in procs] == [0, 1, 2, 3]
    got = procs[0]["dense"]["meshes"]
    assert got[1].shape[0] > 0 and got[3].shape[0] > 0
    for a, b in zip(got, points[0]["dense"]["meshes"]):
        np.testing.assert_array_equal(a, b)
    assert all(p["dense"]["meshes"] is None for p in procs[1:])
    for p, t, d in zip(procs, points, data):
        for part, ref in (("octree", t), ("batch", d)):
            for a, b in zip(p[part]["fields"], ref[part]["fields"]):
                np.testing.assert_array_equal(a, b)
        for k, v in d["step"]["metrics"].items():
            np.testing.assert_allclose(p["step"]["metrics"][k], v,
                                       rtol=SUM_ORDER_TOL, err_msg=k)
        np.testing.assert_array_equal(p["step"]["before"],
                                      d["step"]["before"])
        update = np.subtract(p["step"]["params"], p["step"]["before"])
        want = np.subtract(d["step"]["params"], d["step"]["before"])
        assert rel_err(update, want) <= SUM_ORDER_TOL
        for k, v in d["step"]["stats"].items():
            assert rel_err(p["step"]["stats"][k], v) <= SUM_ORDER_TOL, k
        # every rank applied the same update: the state stays replicated
        assert p["step"]["metrics"] == procs[0]["step"]["metrics"]
        np.testing.assert_array_equal(p["step"]["params"],
                                      procs[0]["step"]["params"])
        for k, v in procs[0]["step"]["stats"].items():
            np.testing.assert_array_equal(p["step"]["stats"][k], v)
    for a, b in zip(procs[0]["batch"]["meshes"][2],
                    data[0]["batch"]["meshes"][2]):
        np.testing.assert_array_equal(a, b)
    # rank r draws its weights from seed + r: the broadcast gave every
    # rank rank 0's
    for p in procs[1:]:
        np.testing.assert_array_equal(p["step"]["before"],
                                      procs[0]["step"]["before"])


def test_config_resolves_sharded():
    cfg = resolve_config(dataclasses.replace(SuRSConfig(),
                                             mc_backend="sharded"), "cpu")
    assert cfg.mc_backend == "sharded"


def test_eval_cli_sharded_backend_matches_device_cubes(tmp_path):
    """The eval CLI with --mc_backend sharded in one process (a one-rank
    mesh): the OBJ pairs of --mc_backend device --mc_algorithm cubes, as
    sets (the merged mesh's faces come out in another order)."""
    from surs_tpu_torch.apps.eval_surs import main
    from surs_tpu_torch.recon.mesh_io import load_obj
    from test_torch_eval import CLI_FLAGS, eval_root
    root = eval_root(tmp_path, names=("subj",))
    flags = [*CLI_FLAGS, "--dataroot", str(root), "--device", "cpu"]
    for backend in ("device", "sharded"):
        main([*flags, "--name", backend, "--mc_backend", backend,
              "--results_path", str(tmp_path / "res")])
    for tag in ("HR", "LR"):
        got = load_obj(str(tmp_path / "res" / "sharded" / f"subj_{tag}.obj"))
        want = load_obj(str(tmp_path / "res" / "device" / f"subj_{tag}.obj"))
        assert got[1].shape[0] > 0
        assert_same_sets(got[0] + 0.5, got[1], want[0] + 0.5, want[1])


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_nccl_without_a_card_raises():
    """No fallback: NCCL or a CUDA mesh without a card raises."""
    with pytest.raises(RuntimeError, match="nccl backend needs a CUDA"):
        spawn(checks.run, 2, backend="nccl", device="cuda", args=({},))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(device_type="cuda")
