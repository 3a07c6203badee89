"""Octree evaluation over dirty column windows, the "runs" mode
(counterpart of ``surs_tpu/recon/evaluator_runs.py``).

The octree's dirty set clusters in short z-runs along grid columns, and
under an axis-aligned calibration every point of a column shares its
(u, v). So each level compacts dirty 8-point z-WINDOWS instead of
points: a window's features are gathered once and kernel K4 scores its
8 depths. Results scatter back masked by the window's dirty bits, so
fill regions and silhouette-pruned points keep their values; the level
schedule, the pruning and the silhouette masks are the mono evaluator's
(recon/evaluator.py).

Depth features: zf is affine in the grid index k under a separable
calibration, so zf(k0 + t) = (zf(k0) - zf(0)) + zf(t): each window gets
its offset kf = zf(k0) - zf(0), all share zt = zf(0..8).

The TPU's bit-packed two-level window compaction and its quad-packed
feature maps are layouts for its vector units; here one
``torch.nonzero`` compacts a level's windows.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.fused_mlp import RUNS_WINDOW, fused_dual_mlp_runs
from ..ops.geometry import in_image_mask, normalize_depth, orthogonal
from ..ops.grid_sample import grid_sample_points
from ..utils.profiling import host_wait
from .evaluator import (check_cols_features, dense_cols_separable,
                        level_schedule, octree_fields)

ZB = RUNS_WINDOW       # z points per window


def runs_supported(calib, mat, resolution: int,
                   init_resolution: int) -> bool:
    """Whether the runs mode applies to this geometry: a column-separable
    calibration and every level's lattice a multiple of the window. The
    port has no weight-shape gate: K4 takes the depth offset as its own
    input, not in a feature pad lane."""
    if not dense_cols_separable(calib, np.asarray(mat)):
        return False
    try:
        schedule = level_schedule(resolution, init_resolution)
    except ValueError:
        return False
    return all((resolution // reso) % ZB == 0 for reso in schedule)


def eval_grid_octree_runs(cols_weights, feat_lr, feat_hr, calib,
                          resolution: int, mat: np.ndarray, threshold: float,
                          load_size: int, z_size: float,
                          init_resolution: int = 64,
                          nwin_chunk: int = 32768, silhouette=None,
                          silhouette_dilate: int = 3,
                          stats: Optional[Dict] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coarse-to-fine evaluation through dirty column windows:
    ``cols_weights`` (ops.fused_mlp.ColsWeights), feature maps
    [1, H, W, C] on the fields' device, ``nwin_chunk`` windows per K4
    launch, ``silhouette`` as the mono evaluator's. Returns (hr, lr)
    [R, R, R] float32; ``stats["queries"]`` counts the points K4 scored
    (windows x 8), ``stats["levels"]`` the levels and ``stats["syncs"]``
    the host's waits on the card."""
    R = resolution
    mat = np.asarray(mat)
    if not runs_supported(calib, mat, R, init_resolution):
        raise ValueError(
            "runs octree mode requires a column-separable calibration and "
            "window-aligned level lattices; use the mono mode")
    check_cols_features(cols_weights, feat_lr, feat_hr)
    dev = feat_lr.device
    with host_wait(stats):
        calib_t = torch.as_tensor(np.asarray(calib, np.float32),
                                  device=dev).reshape(-1, 4, 4)[:1]
    with host_wait(stats):
        offset = torch.tensor(mat[:3, 3], dtype=torch.float32, device=dev)
    tvec = torch.arange(ZB, device=dev)

    def eval_level(reso, dirty, val_hr, val_lr):
        L = R // reso
        Wz = L // ZB
        with host_wait(stats):
            scale = torch.tensor(np.diag(mat[:3, :3]) * reso,
                                 dtype=torch.float32, device=dev)
        # this level's depth features
        kidx = torch.arange(L, dtype=torch.float32, device=dev)
        zero = torch.zeros_like(kidx)
        zpts = torch.stack([zero, zero, kidx]) * scale[:, None] \
            + offset[:, None]
        zf = normalize_depth(orthogonal(zpts[None], calib_t)[0, 2, :],
                             load_size, z_size)
        zt = zf[:ZB].contiguous()
        kf_all = zf - zf[0]
        bits = dirty.reshape(L * L * Wz, ZB)
        with host_wait(stats):
            ids = torch.nonzero(bits.any(dim=1)).squeeze(1)
        flat_hr = val_hr.view(-1)
        flat_lr = val_lr.view(-1)
        for c0 in range(0, ids.numel(), nwin_chunk):
            w = ids[c0:c0 + nwin_chunk]
            cid = w // Wz
            k0 = (w % Wz) * ZB
            pts = torch.stack([cid // L, cid % L, torch.zeros_like(cid)]
                              ).float() * scale[:, None] + offset[:, None]
            xyz = orthogonal(pts[None], calib_t)
            mask = in_image_mask(xyz[:, :2, :])[0][:, None]
            uv = xyz[:, :2, :].transpose(1, 2)
            hr, lr = fused_dual_mlp_runs(
                grid_sample_points(feat_lr, uv)[0],
                grid_sample_points(feat_hr, uv)[0],
                kf_all[k0].contiguous(), zt, cols_weights)
            # only the window's dirty points take the new values
            ok = bits[w]
            with host_wait(stats):
                tgt = ((cid * L + k0)[:, None] + tvec[None, :])[ok]
            with host_wait(stats):
                flat_hr[tgt] = (hr * mask)[ok]
            with host_wait(stats):
                flat_lr[tgt] = (lr * mask)[ok]
        return ids.numel() * ZB

    val_hr, val_lr, queries = octree_fields(
        eval_level, R, mat, threshold, init_resolution, dev, silhouette,
        calib, silhouette_dilate, stats)
    if stats is not None:
        stats["queries"] = stats.get("queries", 0) + queries
    return val_hr, val_lr
