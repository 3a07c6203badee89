"""End-to-end reconstruction (counterpart of
``surs_tpu/recon/pipeline.py``): encode the image once, evaluate the
(HR, LR) occupancy fields (coarse-to-fine, or densely), extract both
meshes with marching cubes on the fields' device and write
``*_HR.obj`` / ``*_LR.obj``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.fused_mlp import FusedWeights
from ..ops.point_query import fused_query
from .evaluator import (dense_cols_separable, eval_grid_dense,
                        eval_grid_dense_cols, eval_grid_octree)
from .evaluator_runs import eval_grid_octree_runs, runs_supported
from .grid import grid_matrix
from .marching import marching_cubes
from .mesh_io import save_obj_mesh


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
    to the model's."""

    def __init__(self, model, weights: FusedWeights, device,
                 feature_dtype: torch.dtype = torch.float32,
                 octree_mode: str = "mono", cols_weights=None,
                 load_size: Optional[int] = None,
                 z_size: Optional[float] = None):
        self.model = model
        self.weights = weights
        self.device = torch.device(device)
        self.feature_dtype = feature_dtype
        self.octree_mode = octree_mode
        self.cols_weights = cols_weights
        self.load_size = model.load_size if load_size is None else load_size
        self.z_size = model.z_size if z_size is None else z_size

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
                 silhouette_dilate: int = 3, stats: Optional[Dict] = None):
        """Both occupancy fields on the R^3 grid spanning [b_min, b_max);
        returns (sdf_hr, sdf_lr, mat). ``silhouette`` ([H, W(, 1)]
        binary mask) enables visual-hull pruning of the octree.
        ``stats["mode"]`` names the path that ran: 'dense-cols', 'dense',
        'octree-runs' or 'octree-mono'; ``stats["queries"]`` counts the
        points scored."""
        R = resolution
        mat = grid_matrix((R,) * 3, b_min, b_max)
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

    @staticmethod
    @torch.inference_mode()
    def extract_pair(sdf_hr, sdf_lr, mat, level: float = 0.5):
        """Yield (verts [V, 3] float32 world, faces [F, 3] int64) numpy
        arrays for the HR then the LR field."""
        mat = np.asarray(mat)
        for sdf in (sdf_hr, sdf_lr):
            verts, faces = marching_cubes(sdf, level)
            verts = verts.cpu().numpy() @ mat[:3, :3].T + mat[:3, 3]
            yield verts.astype(np.float32), faces.cpu().numpy()

    def gen_mesh_begin(self, cfg, data: dict, save_path: str,
                       stats: Optional[Dict] = None):
        """Encode and evaluate one subject; returns ``finish()``, which
        extracts both meshes and writes the OBJ pair, returning
        (path_hr, path_lr)."""
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
            for path, (verts, faces) in zip(
                    paths, self.extract_pair(sdf_hr, sdf_lr, mat)):
                if stats is not None:
                    stats.setdefault("faces", []).append(len(faces))
                save_obj_mesh(path, verts, faces)
            return paths

        return finish

    def gen_mesh(self, cfg, data: dict, save_path: str,
                 stats: Optional[Dict] = None) -> Tuple[str, str]:
        return self.gen_mesh_begin(cfg, data, save_path, stats)()
