"""The multi-device paths driven on every rank, for the callers that
compare them: the CPU tests (ranks as threads, and a gloo spawn) and
``chip_smoke.py``'s ``parallel`` phase (NCCL at world size 1, gloo at
world size 2 on one card). :func:`run` is a worker of ``launch.spawn``
and ``launch.run_threads``; this module imports no JAX.

``run(mesh, spec)`` builds the model of ``spec["cfg"]`` (SuRSConfig
fields) on each rank from the seed ``cfg.seed + rank`` (or loads
``spec["params"]``, a Flax params tree, on rank 0), replicates rank 0's
weights (``replicate_tree``, a broadcast), then runs ``spec["parts"]``
(``step`` on a model of its own when ``spec["step_cfg"]`` overrides
fields):

* ``dense``: ``reconstruct_subject_sharded`` of ``spec["image"]`` over
  the ``points`` axis (K3 on each rank's rows, halo, slab meshes gathered
  and merged on rank 0);
* ``octree``: ``Reconstructor(point_mesh=)``'s mono octree of the same
  image (K1 on each rank's part of every chunk, all-gathered);
* ``batch``: ``ShardedReconstructor`` over ``data``, one image of
  ``spec["images"]`` a rank (K1), its fields gathered and its meshes
  gathered on rank 0;
* ``step``: the data-parallel training step over ``data`` on
  ``spec["batch"]`` (the fused step, K2, with ``spec["fused"]``).

Each part returns its results as numpy arrays, its seconds, the
launches of the kernel it runs (as this process counted them) and the
card's peak memory. With ``spec["reference"]`` each rank then runs the
part's single-device counterpart on the same weights (the dense meshes
on rank 0 only), outside the timed and counted run.
"""

from __future__ import annotations

import copy
import time
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from ..compat.flax_import import load_flax_params
from ..config import SuRSConfig, resolve_config
from ..models.surs_net import surs_net_from_config
from ..ops import fused_mlp as fm
from ..ops.point_query import fused_query
from ..recon.evaluator import eval_grid_dense_cols, eval_grid_octree
from ..recon.grid import grid_matrix
from ..recon.marching import marching_cubes
from ..recon.pipeline import (Reconstructor, build_reconstructor,
                              eval_calibration)
from ..train.fused_step import make_fused_train_step
from ..train.optim import make_optimizer
from ..train.step import create_train_state, make_train_step
from .batch_recon import ShardedReconstructor
from .mesh import (DATA_AXIS, POINT_AXIS, Mesh, make_mesh, replicate_tree,
                   shard_batch)
from .single_subject import reconstruct_subject_sharded

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_AXIS = {"dense": POINT_AXIS, "octree": POINT_AXIS, "batch": DATA_AXIS,
         "step": DATA_AXIS}
# the kernel wrapper each part's launches are read from
_KERNEL = {"dense": fm.fused_dual_mlp_cols, "octree": fm.fused_dual_mlp,
           "batch": fm.fused_dual_mlp, "step": fm.fused_dual_mlp_train}


def run(mesh: Mesh, spec: Dict) -> Dict:
    dev = mesh.device
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg, model = _model(mesh, spec["cfg"], spec.get("params"))
    out = {"rank": mesh.rank}
    for part in spec["parts"]:
        m = _mesh_for(mesh, _AXIS[part])
        if part == "step" and spec.get("step_cfg"):
            cfg, model = _model(mesh, {**spec["cfg"], **spec["step_cfg"]})
        kernel = _KERNEL[part]
        _sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        kernel.launches = 0
        t0 = time.perf_counter()
        res, reference = _PARTS[part](m, model, cfg, spec)
        _sync(dev)
        res["seconds"] = time.perf_counter() - t0
        res["launches"] = kernel.launches
        if dev.type == "cuda":
            res["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
        if spec.get("reference"):
            reference(res)
        out[part] = res
    return out


def _model(mesh: Mesh, fields: Dict, params=None):
    """The resolved config and its model on every rank: rank r draws
    from ``seed + r`` (rank 0 loads ``params`` when given), then every
    rank takes rank 0's weights."""
    cfg = resolve_config(SuRSConfig(**fields), mesh.device)
    model = surs_net_from_config(cfg, mesh.device, seed=cfg.seed + mesh.rank)
    if params is not None and mesh.rank == 0:
        load_flax_params(model, params)
    return cfg, replicate_tree(model, mesh)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _mesh_for(mesh: Mesh, axis: str) -> Mesh:
    """``mesh`` when ``axis`` spans every rank, else the process group's
    mesh with every rank on ``axis`` (a thread run has one shape)."""
    world = mesh.world.size
    if mesh.size(axis) == world:
        return mesh
    if not dist.is_initialized():
        raise ValueError(f"part needs every rank on {axis!r}; this thread "
                         f"mesh has {mesh.shape}")
    n_data = world if axis == DATA_AXIS else 1
    return make_mesh(n_data=n_data, n_points=world // n_data,
                     device_type=mesh.device.type)


def _world(verts, faces, mat):
    return (verts @ mat[:3, :3].T + mat[:3, 3]).astype(np.float32), faces


@torch.inference_mode()
def _dense(mesh, model, cfg, spec):
    dev = mesh.device
    img = torch.as_tensor(spec["image"], device=dev)
    _, feats_lr, feat_hr = model.encode(img)
    cw = fm.prepare_cols_weights(model.mlp_lr, model.mlp_hr, cfg.hg_dim,
                                 dtype=_DTYPES[cfg.feature_dtype])
    calib = eval_calibration(1)
    R = cfg.resolution
    got = reconstruct_subject_sharded(
        cw, feats_lr[-1], feat_hr, calib, R, cfg.b_min, cfg.b_max,
        cfg.loadSize, cfg.z_size, mesh, algorithm=spec.get("algorithm",
                                                            "cubes"))

    @torch.inference_mode()
    def reference(res):
        if got is None:
            return
        mat = grid_matrix((R,) * 3, cfg.b_min, cfg.b_max)
        fields = eval_grid_dense_cols(cw, feats_lr[-1], feat_hr, calib, R,
                                      mat, cfg.loadSize, cfg.z_size)
        ref = []
        for sdf in fields:
            v, f = marching_cubes(sdf, 0.5)
            ref += list(_world(v.cpu().numpy(), f.cpu().numpy(), mat))
        res["reference"] = tuple(ref)

    return {"meshes": got}, reference


@torch.inference_mode()
def _octree(mesh, model, cfg, spec):
    dev = mesh.device
    img = torch.as_tensor(spec["image"], device=dev)
    rec = build_reconstructor(cfg, model, dev, "mono")
    prec = Reconstructor(model, rec.weights, dev, rec.feature_dtype,
                         point_mesh=mesh, load_size=cfg.loadSize,
                         z_size=cfg.z_size)
    _, feats_lr, feat_hr = model.encode(img)
    args = (feats_lr, feat_hr, eval_calibration(1), cfg.resolution,
            cfg.b_min, cfg.b_max)
    kw = dict(num_samples=cfg.num_samples, threshold=cfg.threshold,
              init_resolution=cfg.octree_init_resolution,
              silhouette=spec.get("mask"))
    hr, lr, _ = prec.evaluate(*args, **kw)
    res = {}
    if spec.get("return_fields"):
        res["fields"] = (hr.cpu().numpy(), lr.cpu().numpy())

    @torch.inference_mode()
    def reference(res):
        rhr, rlr, _ = rec.evaluate(*args, **kw)
        res["bitwise"] = bool(torch.equal(hr, rhr) and torch.equal(lr, rlr))
        res["max_abs_diff"] = max((hr - rhr).abs().max().item(),
                                  (lr - rlr).abs().max().item())

    return res, reference


@torch.inference_mode()
def _batch(mesh, model, cfg, spec):
    dev = mesh.device
    rec = build_reconstructor(cfg, model, dev, "mono")
    b = mesh.index(DATA_AXIS)
    img = torch.as_tensor(spec["images"][b:b + 1], device=dev)
    _, feats_lr, feat_hr = model.encode(img)
    fdt = rec.feature_dtype
    ctx = {"feat_lr": feats_lr[-1].to(fdt), "feat_hr": feat_hr.to(fdt),
           "calib": torch.as_tensor(eval_calibration(1), device=dev)}

    def eval_fn(points, c):
        hr, lr = fused_query(rec.weights, c["feat_lr"], c["feat_hr"],
                             points[None], c["calib"], cfg.loadSize,
                             cfg.z_size)
        return hr[0], lr[0]

    srec = ShardedReconstructor(
        eval_fn, mesh, cfg.resolution, cfg.b_min, cfg.b_max,
        threshold=cfg.threshold, init_resolution=cfg.octree_init_resolution,
        num_samples=cfg.num_samples)
    hr, lr = srec.evaluate(ctx, gather=True, local=True)
    res = {"meshes": srec.reconstruct(ctx, local=True)}
    if spec.get("return_fields"):
        res["fields"] = (hr.cpu().numpy(), lr.cpu().numpy())

    @torch.inference_mode()
    def reference(res):
        # rank b's own subject through the single-device octree
        rhr, rlr = eval_grid_octree(
            lambda p: eval_fn(p, ctx), cfg.resolution, srec.mat,
            cfg.threshold, init_resolution=cfg.octree_init_resolution,
            num_samples=cfg.num_samples, device=dev)
        res["bitwise"] = bool(torch.equal(hr[b], rhr)
                              and torch.equal(lr[b], rlr))

    return res, reference


def _step(mesh, model, cfg, spec):
    dev = mesh.device
    make = make_fused_train_step if spec.get("fused") else make_train_step
    batch = {k: torch.as_tensor(v) for k, v in spec["batch"].items()}
    start = copy.deepcopy(model) if spec.get("reference") else None
    before = _flat(model)
    st = create_train_state(model, make_optimizer(cfg, model.parameters()))
    st, m = make(model, st.optimizer, mesh=mesh)(st, shard_batch(batch,
                                                                 mesh))
    after = _flat(model)
    res = {"metrics": _scalars(m),
           "stats": {k: v.cpu().numpy() for k, v in
                     model.state_dict().items() if "running" in k}}
    if spec.get("return_params"):
        res["before"], res["params"] = before.cpu().numpy(), \
            after.cpu().numpy()

    def reference(res):
        # the single-device step on the whole batch, from the same weights
        st = create_train_state(start, make_optimizer(cfg,
                                                      start.parameters()))
        st, m = make(start, st.optimizer)(
            st, {k: v.to(dev) for k, v in batch.items()})
        d_ref, d_got = _flat(start) - before, after - before
        res["reference"] = _scalars(m)
        # the whole update against the single-device step's, relative
        res["update_rel_err"] = float(
            torch.linalg.vector_norm(d_got - d_ref)
            / torch.linalg.vector_norm(d_ref))

    return res, reference


def _scalars(metrics) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items()
            if k not in ("pred_hr", "pred_lr")}


def _flat(model) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


_PARTS = {"dense": _dense, "octree": _octree, "batch": _batch,
          "step": _step}
