"""End-to-end reconstruction (counterpart of
``surs_tpu/recon/pipeline.py``): encode the image once, evaluate the
(HR, LR) occupancy fields (coarse-to-fine, or densely), extract both
meshes (marching cubes or tetrahedra on the fields' device, or marching
tetrahedra in the host library) and write ``*_HR.obj`` / ``*_LR.obj``
through the host library.

    rec = build_reconstructor(cfg, model, device, cfg.serve_octree_mode)
    rec.gen_mesh(cfg, data, "out/subject.obj")

The functional ``reconstruction`` and ``gen_mesh`` build a
``Reconstructor`` for one call.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.fused_mlp import (FusedWeights, prepare_cols_weights,
                             prepare_fused_weights)
from ..ops.point_query import fused_query
from .evaluator import (dense_cols_separable, eval_grid_dense,
                        eval_grid_dense_cols, eval_grid_octree)
from .evaluator_runs import eval_grid_octree_runs, runs_supported
from .grid import grid_matrix, require_diagonal
from .marching import CapacityError, extract_isosurface, marching_cubes
from .mesh_io import save_obj_mesh
from .tetra import marching_tetrahedra

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_DEVICE_EXTRACTORS = {"cubes": marching_cubes, "tets": marching_tetrahedra}
# the keys of mc_caps the device extractors take; others are dropped so
# that one mc_caps can serve every backend (surs_tpu/recon/pipeline.py:350)
_DEVICE_CAPS = ("max_cells", "max_tris", "max_verts", "max_pts",
                "cell_chunk")
# those of the sharded extractor (surs_tpu/recon/pipeline.py:326-327);
# 'local' says the fields are this rank's x-slabs
_SHARDED_CAPS = ("mesh", "axis", "algorithm", "cell_chunk",
                 "max_cells_shard", "max_tris_shard", "local")


def eval_calibration(batch: int = 1) -> np.ndarray:
    """The fixed orthographic eval calibration diag(2, -2, 2, 1)."""
    calib = np.diag([2.0, -2.0, 2.0, 1.0]).astype(np.float32)
    return np.tile(calib[None], (batch, 1, 1))


class Reconstructor:
    """Reconstruction engine for one model: ``model`` (models.SuRSNet)
    encodes, ``weights`` (ops.fused_mlp.FusedWeights prepared from the
    model's MLPs) score points through kernel K1. Feature maps are
    stored in ``feature_dtype`` for the point and window gathers.

    ``cols_weights`` (ops.fused_mlp.ColsWeights) enables the column
    paths, as in ``surs_tpu/recon/pipeline.py:52-71``:
    ``evaluate(use_octree=False)`` scores the whole grid through kernel
    K3 when the calibration is column-separable, and ``octree_mode``
    'runs' evaluates the octree through dirty column windows and kernel
    K4 when the geometry allows it. Otherwise the generic dense path or
    the mono octree (both through K1) runs; 'hostloop', 'fused' and
    'mono' all name the mono octree. ``load_size`` and ``z_size`` default
    to the model's. A multi-view model raises: it trains only.

    ``point_mesh`` (parallel.Mesh) splits each chunk of the K1 paths'
    points over the mesh's ``points`` ranks, each rank scoring its part
    and all of them gathering the parts (``surs_tpu/recon/
    pipeline.py:107-111``); every rank runs the same octree and gets the
    same fields. ``num_samples`` must then divide by the axis size."""

    def __init__(self, model, weights: FusedWeights, device,
                 feature_dtype: torch.dtype = torch.float32,
                 octree_mode: str = "mono", cols_weights=None,
                 load_size: Optional[int] = None,
                 z_size: Optional[float] = None, point_mesh=None):
        if model.num_views != 1:
            raise ValueError(
                f"num_views={model.num_views}: the JAX package has no "
                "multi-view serving path (its classifier averages views "
                "that a single image does not have; ROADMAP.md C7)")
        self.model = model
        self.weights = weights
        self.device = torch.device(device)
        self.feature_dtype = feature_dtype
        self.octree_mode = octree_mode
        self.cols_weights = cols_weights
        self.load_size = model.load_size if load_size is None else load_size
        self.z_size = model.z_size if z_size is None else z_size
        self.point_mesh = point_mesh

    @torch.inference_mode()
    def encode(self, images):
        """images [B, S, S, 3] -> (img_sr, feats_lr, feat_hr), NHWC."""
        images = torch.as_tensor(np.asarray(images, np.float32),
                                 device=self.device)
        return self.model.encode(images)

    @torch.inference_mode()
    def evaluate(self, feats_lr, feat_hr, calib: np.ndarray,
                 resolution: int, b_min, b_max, use_octree: bool = True,
                 num_samples: int = 50000, threshold: float = 0.05,
                 init_resolution: int = 64, silhouette=None,
                 silhouette_dilate: int = 3, stats: Optional[Dict] = None,
                 transform: Optional[np.ndarray] = None):
        """Both occupancy fields on the R^3 grid spanning [b_min, b_max);
        returns (sdf_hr, sdf_lr, mat). ``transform`` (4x4, axis-aligned:
        anything else raises) maps the grid's world points once more.
        ``silhouette`` ([H, W(, 1)] binary mask) enables visual-hull
        pruning of the octree.
        ``stats["mode"]`` names the path that ran: 'dense-cols', 'dense',
        'octree-runs' or 'octree-mono'; ``stats["queries"]`` counts the
        points scored."""
        R = resolution
        mat = grid_matrix((R,) * 3, b_min, b_max)
        if transform is not None:
            mat = require_diagonal(np.asarray(transform) @ mat,
                                   "Reconstructor.evaluate(transform=)")
        stats = {} if stats is None else stats
        cw = self.cols_weights
        if not use_octree and cw is not None \
                and dense_cols_separable(calib, mat):
            # the column path gathers once per column, so the maps stay
            # in the dtype encode returns
            stats["mode"] = "dense-cols"
            stats["queries"] = stats.get("queries", 0) + R ** 3
            sdf_hr, sdf_lr = eval_grid_dense_cols(
                cw, feats_lr[-1], feat_hr, calib, R, mat, self.load_size,
                self.z_size)
            return sdf_hr, sdf_lr, mat
        f_lr = feats_lr[-1].to(self.feature_dtype)
        f_hr = feat_hr.to(self.feature_dtype)
        if use_octree and self.octree_mode == "runs" and cw is not None \
                and runs_supported(calib, mat, R, init_resolution):
            stats["mode"] = "octree-runs"
            sdf_hr, sdf_lr = eval_grid_octree_runs(
                cw, f_lr, f_hr, calib, R, mat, threshold, self.load_size,
                self.z_size, init_resolution=init_resolution,
                silhouette=silhouette, silhouette_dilate=silhouette_dilate,
                stats=stats)
            return sdf_hr, sdf_lr, mat
        calib_t = torch.as_tensor(np.asarray(calib, np.float32),
                                  device=self.device)

        def eval_fn(points):
            hr, lr = fused_query(self.weights, f_lr, f_hr, points[None],
                                 calib_t, self.load_size, self.z_size)
            return hr[0], lr[0]

        if self.point_mesh is not None:
            from ..parallel.batch_recon import shard_eval_fn_over_points
            from ..parallel.mesh import POINT_AXIS
            n = self.point_mesh.size(POINT_AXIS)
            if num_samples % n:
                raise ValueError(
                    f"point-sharded evaluation needs num_samples "
                    f"({num_samples}) divisible by the '{POINT_AXIS}' "
                    f"axis size {n}")
            eval_fn = shard_eval_fn_over_points(eval_fn, self.point_mesh)
        if not use_octree:
            stats["mode"] = "dense"
            stats["queries"] = stats.get("queries", 0) + R ** 3
            sdf_hr, sdf_lr = eval_grid_dense(eval_fn, R, mat, num_samples,
                                             device=self.device)
            return sdf_hr, sdf_lr, mat
        stats["mode"] = "octree-mono"
        sdf_hr, sdf_lr = eval_grid_octree(
            eval_fn, R, mat, threshold,
            init_resolution=init_resolution, num_samples=num_samples,
            device=self.device, silhouette=silhouette,
            silhouette_calib=calib, silhouette_dilate=silhouette_dilate,
            stats=stats)
        return sdf_hr, sdf_lr, mat

    def reconstruct(self, feats_lr, feat_hr, calib: np.ndarray,
                    resolution: int, b_min, b_max, use_octree: bool = True,
                    num_samples: int = 50000, threshold: float = 0.05,
                    init_resolution: int = 64,
                    transform: Optional[np.ndarray] = None,
                    level: float = 0.5, silhouette=None,
                    mc_backend: str = "host", mc_caps: Optional[Dict] = None,
                    stats: Optional[Dict] = None):
        """Evaluation and extraction: (verts_hr, faces_hr, verts_lr,
        faces_lr) numpy arrays, world coordinates. ``mc_backend`` and
        ``mc_caps`` choose the extractor as in :meth:`extract_pair`; the
        default is the JAX package's, the host library's marching
        tetrahedra."""
        sdf_hr, sdf_lr, mat = self.evaluate(
            feats_lr, feat_hr, calib, resolution, b_min, b_max,
            use_octree=use_octree, num_samples=num_samples,
            threshold=threshold, init_resolution=init_resolution,
            silhouette=silhouette, stats=stats, transform=transform)
        out = []
        for verts, faces in self.extract_pair(sdf_hr, sdf_lr, mat, level,
                                              mc_backend, mc_caps, stats):
            out += [verts, faces]
        return tuple(out)

    @staticmethod
    @torch.inference_mode()
    def extract_pair(sdf_hr, sdf_lr, mat, level: float = 0.5,
                     mc_backend: str = "host", mc_caps: Optional[Dict] = None,
                     stats: Optional[Dict] = None):
        """Yield (verts [V, 3] float32 world, faces [F, 3] int64) numpy
        arrays for the HR then the LR field
        (``surs_tpu/recon/pipeline.py:295-380``). ``mc_backend``:

        * 'device': ``mc_caps["algorithm"]`` ('cubes', or 'tets' by
          default) on the fields' device. Both meshes are extracted, and
          both copies to the host started, before the HR mesh is yielded:
          on the card the LR mesh's copy into pinned memory runs while the
          caller writes the HR file;
        * 'host': each field copied to the host and meshed by the host
          library's marching tetrahedra (the algorithm key is not read);
        * 'auto': 'device', and 'host' only when a capacity in ``mc_caps``
          (``max_cells``, ``max_tris``, ``max_verts``, ``max_pts``; none by
          default) is exceeded;
        * 'sharded': one x-slab a rank of ``mc_caps["mesh"]``'s
          ``mc_caps["axis"]`` (default: every rank of the process group,
          or this process alone), merged on the axis' rank 0
          (``parallel/sharded_mc.py``; ``algorithm`` 'cubes' by default,
          ``cell_chunk``, ``max_cells_shard``, ``max_tris_shard``, and
          ``local`` when the fields are this rank's slabs). The other
          ranks get None for each mesh, and every rank must take both.

        ``stats["mc"]`` names what ran ('device/tets', 'device/cubes',
        'host/tets', 'sharded/cubes' or 'sharded/tets'); an 'auto'
        fallback also sets ``stats["mc_fallback"]`` to the capacity
        error."""
        mat = np.asarray(mat)
        caps = mc_caps or {}
        stats = {} if stats is None else stats

        def to_world(verts, faces):
            verts = verts @ mat[:3, :3].T + mat[:3, 3]
            return verts.astype(np.float32), faces

        if mc_backend == "sharded":
            from ..parallel.sharded_mc import \
                extract_isosurface_sharded_begin
            kw = {k: v for k, v in caps.items() if k in _SHARDED_CAPS}
            # both fields begin (halo, counts) before either resolves
            res = [extract_isosurface_sharded_begin(
                sdf, level, defer_sync=True, **kw)
                for sdf in (sdf_hr, sdf_lr)]
            stats["mc"] = f"sharded/{kw.get('algorithm', 'cubes')}"
            for finish in [r() for r in res]:
                mesh = finish()
                yield None if mesh is None else to_world(*mesh)
            return
        if mc_backend not in ("device", "host", "auto"):
            raise ValueError(f"unknown mc_backend {mc_backend!r}")
        if mc_backend in ("device", "auto"):
            algorithm = caps.get("algorithm", "tets")
            if algorithm not in _DEVICE_EXTRACTORS:
                raise ValueError(f"unknown mc algorithm {algorithm!r}")
            extract = _DEVICE_EXTRACTORS[algorithm]
            kw = {k: v for k, v in caps.items() if k in _DEVICE_CAPS}
            try:
                staged = [_to_host(*extract(sdf, level, **kw))
                          for sdf in (sdf_hr, sdf_lr)]
            except CapacityError as err:
                if mc_backend == "device":
                    raise
                stats["mc_fallback"] = str(err)
            else:
                stats["mc"] = f"device/{algorithm}"
                for fetch in staged:
                    yield to_world(*fetch())
                return
        stats["mc"] = "host/tets"
        for sdf in (sdf_hr, sdf_lr):
            yield to_world(*extract_isosurface(sdf, level, "native"))

    def gen_mesh_begin(self, cfg, data: dict, save_path: str,
                       stats: Optional[Dict] = None):
        """Encode and evaluate one subject; returns ``finish()``, which
        extracts both meshes and writes the OBJ pair, returning
        (path_hr, path_lr). ``stats`` gathers the evaluation's mode and
        queries, the faces of each mesh and the seconds of the OBJ
        writes (``write_s``), the seconds spent extracting (``extract_s``)
        and the extractor that ran (``mc``). The extractor is
        ``cfg.mc_backend`` with ``cfg.mc_algorithm``
        (``surs_tpu/recon/pipeline.py:419-428``)."""
        _, feats_lr, feat_hr = self.encode(data["img_LR"])
        if "calib" in data:
            calib = np.asarray(data["calib"], np.float32).reshape(-1, 4, 4)
        else:
            calib = eval_calibration(np.asarray(data["img_LR"]).shape[0])
        silhouette = None
        if cfg.mask_prune and "mask_LR" in data:
            silhouette = data["mask_LR"]
        sdf_hr, sdf_lr, mat = self.evaluate(
            feats_lr, feat_hr, calib, cfg.resolution, data["b_min"],
            data["b_max"], use_octree=cfg.use_octree,
            num_samples=cfg.num_samples,
            threshold=cfg.threshold,
            init_resolution=cfg.octree_init_resolution,
            silhouette=silhouette, stats=stats)
        stem = os.path.splitext(save_path)[0]
        paths = (stem + "_HR.obj", stem + "_LR.obj")

        def finish() -> Tuple[str, str]:
            st = {} if stats is None else stats
            meshes = self.extract_pair(
                sdf_hr, sdf_lr, mat, mc_backend=cfg.mc_backend,
                mc_caps={"algorithm": cfg.mc_algorithm}, stats=st)
            for path in paths:
                t0 = time.perf_counter()
                mesh = next(meshes)
                t1 = time.perf_counter()
                if mesh is None:        # a sharded mesh lands on rank 0
                    continue
                verts, faces = mesh
                save_obj_mesh(path, verts, faces)
                st.setdefault("faces", []).append(len(faces))
                st["extract_s"] = st.get("extract_s", 0.0) + t1 - t0
                st["write_s"] = (st.get("write_s", 0.0)
                                 + time.perf_counter() - t1)
            return paths

        return finish

    def gen_mesh(self, cfg, data: dict, save_path: str,
                 stats: Optional[Dict] = None) -> Tuple[str, str]:
        return self.gen_mesh_begin(cfg, data, save_path, stats)()


def _to_host(verts: torch.Tensor, faces: torch.Tensor):
    """Start copying a mesh to the host; returns ``fetch() -> (verts,
    faces)`` numpy arrays. On the card the copies go into pinned memory,
    non-blocking, and ``fetch`` waits for them alone."""
    if verts.device.type != "cuda":
        return lambda: (verts.numpy(), faces.numpy())
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in (verts, faces)]
    for h, t in zip(host, (verts, faces)):
        h.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def fetch():
        done.synchronize()
        return host[0].numpy(), host[1].numpy()

    return fetch


def build_reconstructor(cfg, model, device, octree_mode: str
                        ) -> Reconstructor:
    """A Reconstructor for ``model`` under a resolved config: K1's
    weights packed in ``cfg.feature_dtype``, and the column weights of
    K3 and K4 where dense evaluation or the runs octree needs them. The
    packed weights are copies: load the model's weights first."""
    kdt = _DTYPES[cfg.feature_dtype]
    weights = prepare_fused_weights(model.mlp_lr, model.mlp_hr, dtype=kdt)
    cols = None
    if not cfg.use_octree or octree_mode == "runs":
        cols = prepare_cols_weights(model.mlp_lr, model.mlp_hr, cfg.hg_dim,
                                    dtype=kdt)
    return Reconstructor(model, weights, device, feature_dtype=kdt,
                         octree_mode=octree_mode, cols_weights=cols,
                         load_size=cfg.loadSize, z_size=cfg.z_size)


def reconstruction(model, feats_lr, feat_hr, calib, resolution: int, b_min,
                   b_max, use_octree: bool = True, num_samples: int = 50000,
                   threshold: float = 0.05, init_resolution: int = 64,
                   transform: Optional[np.ndarray] = None,
                   weights: Optional[FusedWeights] = None,
                   level: float = 0.5, mc_backend: str = "host",
                   mc_caps: Optional[Dict] = None):
    """Evaluate both occupancy fields and extract both meshes
    (``surs_tpu/recon/pipeline.py:476``) on the features' device;
    ``weights`` default to the model's MLPs packed in float32, the
    extractor to the host library's marching tetrahedra
    (``Reconstructor.extract_pair``). Returns (verts_hr, faces_hr,
    verts_lr, faces_lr)."""
    if weights is None:
        weights = prepare_fused_weights(model.mlp_lr, model.mlp_hr,
                                        dtype=torch.float32)
    rec = Reconstructor(model, weights, feat_hr.device)
    return rec.reconstruct(feats_lr, feat_hr, calib, resolution, b_min,
                           b_max, use_octree, num_samples, threshold,
                           init_resolution, transform, level,
                           mc_backend=mc_backend, mc_caps=mc_caps)


def gen_mesh(cfg, model, data: dict, save_path: str,
             stats: Optional[Dict] = None) -> Tuple[str, str]:
    """One subject's OBJ pair (``surs_tpu/recon/pipeline.py:491``) under
    a resolved config, with ``cfg.octree_mode``; builds the
    Reconstructor for this call, so prefer :func:`build_reconstructor`
    or the service for loops."""
    device = next(model.parameters()).device
    rec = build_reconstructor(cfg, model, device, cfg.octree_mode)
    return rec.gen_mesh(cfg, data, save_path, stats)


def make_point_eval(model, feats_lr, feat_hr, calib,
                    weights: Optional[FusedWeights] = None):
    """A [3, C] -> (hr [C], lr [C]) evaluator of ``model``'s occupancy
    over the given features and calibration, through the port's query
    (kernel K1; ``surs_tpu/recon/pipeline.py:511-524``). ``weights``
    default to the model's MLPs packed in float32."""
    if weights is None:
        weights = prepare_fused_weights(model.mlp_lr, model.mlp_hr,
                                        dtype=torch.float32)
    calib_t = torch.as_tensor(np.asarray(calib, np.float32),
                              device=feat_hr.device)

    @torch.inference_mode()
    def eval_fn(points):
        pts = torch.as_tensor(points, dtype=torch.float32,
                              device=feat_hr.device)
        hr, lr = fused_query(weights, feats_lr[-1], feat_hr, pts[None],
                             calib_t, model.load_size, model.z_size)
        return hr[0], lr[0]

    return eval_fn
