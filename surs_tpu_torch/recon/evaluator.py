"""Occupancy evaluation over the grid: the mono octree semantics of
``eval_grid_octree_mono`` (``surs_tpu/recon/evaluator.py:606``) in plain
torch, on whatever device the evaluation function uses, and the dense
evaluators (generic per point through K1, and column-shared through K3).

Each level lives on its own L^3 lattice (L = R / stride):

  * the still-dirty lattice points are compacted with ``torch.nonzero``
    and evaluated in chunks of ``num_samples`` points (one K1 launch per
    chunk on the serving path);
  * between levels, a cell whose center is still dirty and whose 8 corner
    values span less than ``threshold`` is filled with (max + min) / 2 and
    cleared; the dirty mask is shared by the HR and LR fields while the
    fill values are per field (``_prune_upsample``, :365-448); then the
    lattice expands to the next level's.

Visual-hull pruning (``silhouette``): a lattice point or cell center
whose projection misses the dilated 2-D silhouette starts clean with
occupancy 0 and is never queried (:755-833). With the production
orthographic calibration the projected uv is constant along one lattice
axis, so each level's mask is a 2-D hit map broadcast along that axis.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import resolve_device
from ..ops.fused_mlp import fused_dual_mlp_cols
from ..ops.geometry import in_image_mask, normalize_depth, orthogonal
from ..ops.grid_sample import grid_sample_points
from ..utils.profiling import annotate, host_wait
from .grid import flat_index_to_world

# eval_fn: [3, C] float32 world points -> (hr [C], lr [C])
EvalFn = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def level_schedule(R: int, init_resolution: int):
    """Stride halving schedule R/init, ..., 1; every stride must divide R
    and each next stride its predecessor."""
    reso = R // init_resolution
    out = []
    while reso > 0:
        out.append(reso)
        reso //= 2
    for i, s in enumerate(out):
        nxt = out[i + 1] if i + 1 < len(out) else None
        if R % s != 0 or (nxt is not None and s % nxt != 0):
            raise ValueError(
                f"unsupported octree schedule {out} for resolution {R}: "
                f"use a power-of-two resolution/init_resolution ratio")
    return out


def _expand(x: torch.Tensor, f: int) -> torch.Tensor:
    """[A, A, A] -> [fA, fA, fA], nearest (value at floor(p / f))."""
    if f == 1:
        return x
    A = x.shape[0]
    return x[:, None, :, None, :, None].expand(A, f, A, f, A, f) \
        .reshape(f * A, f * A, f * A)


def _pad_cells(c: torch.Tensor) -> torch.Tensor:
    """[n, n, n] cell array -> [n+1, n+1, n+1], zero/False at the end."""
    n = c.shape[0]
    out = c.new_zeros((n + 1,) * 3)
    out[:n, :n, :n] = c
    return out


def _prune_upsample(reso: int, threshold: float, val_hr, val_lr, evald,
                    rfh, rfl, dirty, init_center):
    """Fill the prunable cells of the [L]^3 level and expand every state
    tensor to the next level's [fL]^3 lattice."""
    L = val_hr.shape[0]
    n = L - 1
    f = reso // (reso // 2)
    evald = evald | dirty    # every dirty point was evaluated this level

    def spans(v):
        c = torch.stack([v[:-1, :-1, :-1], v[:-1, :-1, 1:], v[:-1, 1:, :-1],
                         v[:-1, 1:, 1:], v[1:, :-1, :-1], v[1:, :-1, 1:],
                         v[1:, 1:, :-1], v[1:, 1:, 1:]])
        return c.amin(dim=0), c.amax(dim=0)

    vmin_hr, vmax_hr = spans(val_hr)
    vmin_lr, vmax_lr = spans(val_lr)
    center_ok = ~(rfh[:n, :n, :n] | rfl[:n, :n, :n])
    if init_center is not None:
        center_ok = center_ok & init_center
    fill_hr = center_ok & ((vmax_hr - vmin_hr) < threshold)
    fill_lr = center_ok & ((vmax_lr - vmin_lr) < threshold)

    e1 = (torch.arange(f * L, device=val_hr.device) % f) == 0
    coarse_pt = e1[:, None, None] & e1[None, :, None] & e1[None, None, :]

    def expand_field(val, rf, fill, vmin, vmax):
        fillp = _pad_cells(fill)
        fvp = _pad_cells((vmax + vmin) * 0.5)
        rf_old = _pad_cells(rf[:n, :n, :n])
        v_on = torch.where(fillp, fvp, val)
        v_off = torch.where(fillp, fvp,
                            torch.where(rf_old, val, torch.zeros_like(val)))
        val2 = torch.where(coarse_pt, _expand(v_on, f), _expand(v_off, f))
        return val2, _expand(rf_old | fillp, f)

    val_hr, rfh = expand_field(val_hr, rfh, fill_hr, vmin_hr, vmax_hr)
    val_lr, rfl = expand_field(val_lr, rfl, fill_lr, vmin_lr, vmax_lr)
    evald = _expand(evald, f) & coarse_pt
    return val_hr, val_lr, evald, rfh, rfl


# ------------------------------------------------------------------------
def sil_null_axis(calib_np: np.ndarray, mat: np.ndarray) -> Optional[int]:
    """Lattice axis along which the projected uv is constant, or None."""
    J = np.asarray(calib_np)[0, :2, :3] @ np.diag(np.diag(mat[:3, :3]))
    null_axes = np.where(np.abs(J).sum(axis=0) == 0.0)[0]
    return int(null_axes[0]) if len(null_axes) else None


def _sil_dilate(mask: torch.Tensor, dilate: int) -> torch.Tensor:
    """Max-window dilation of an [H, W, 1] mask over a (2d+1)^2 window
    (padding counts as -inf)."""
    if dilate <= 0:
        return mask
    m = F.max_pool2d(mask.permute(2, 0, 1)[None], 2 * dilate + 1,
                     stride=1, padding=dilate)
    return m[0].permute(1, 2, 0)


def _sil_hit_lattice(mask, calib, L: int, mat_l: np.ndarray,
                     null_axis: int, stats: Optional[Dict] = None
                     ) -> torch.Tensor:
    """[L, L, L] bool visual-hull hits of an already dilated mask."""
    dev = mask.device
    axes = [a for a in range(3) if a != null_axis]
    ii = torch.arange(L, dtype=torch.float32, device=dev)
    coords = [torch.zeros(L * L, device=dev)] * 3
    coords[axes[0]] = ii.repeat_interleave(L)
    coords[axes[1]] = ii.repeat(L)
    with host_wait(stats):
        scale = torch.tensor(np.diag(mat_l[:3, :3]), dtype=torch.float32,
                             device=dev)
    with host_wait(stats):
        offset = torch.tensor(mat_l[:3, 3], dtype=torch.float32, device=dev)
    pts = torch.stack(coords) * scale[:, None] + offset[:, None]
    xyz = orthogonal(pts[None], calib)
    uv = xyz[:, :2, :].transpose(1, 2)
    hit2 = grid_sample_points(mask[None], uv)[0, :, 0] > 0.0
    shape = [1, 1, 1]
    shape[axes[0]] = L
    shape[axes[1]] = L
    return hit2.reshape(shape).expand(L, L, L)


def silhouette_masks(mask, calib_np: np.ndarray, R: int, mat: np.ndarray,
                     schedule, dilate: int, device,
                     stats: Optional[Dict] = None):
    """Per-level visual-hull masks: ({stride: [L,L,L] lattice hits},
    {stride: [L-1]^3 next-level cell-center hits}); ``stats`` counts the
    copies to the device as host waits."""
    null_axis = sil_null_axis(calib_np, mat)
    if null_axis is None:
        raise ValueError(
            "silhouette pruning needs the 2-D projection fast path (an "
            "orthographic lattice axis)")
    with host_wait(stats):
        mask = torch.as_tensor(mask, dtype=torch.float32, device=device)
    if mask.dim() == 2:
        mask = mask[..., None]
    mask = _sil_dilate(mask, dilate)
    with host_wait(stats):
        calib = torch.as_tensor(np.asarray(calib_np), dtype=torch.float32,
                                device=device)
    lat: Dict = {}
    center: Dict = {}
    for reso in schedule:
        L = R // reso
        mat_l = mat.copy()
        mat_l[:3, :3] = mat[:3, :3] * reso
        lat[reso] = _sil_hit_lattice(mask, calib, L, mat_l, null_axis,
                                     stats)
        if reso > 1:
            mat_c = mat_l.copy()
            mat_c[:3, 3] = mat_c[:3, 3] + np.diag(mat[:3, :3]) * (reso // 2)
            center[reso] = _sil_hit_lattice(mask, calib, L - 1, mat_c,
                                            null_axis, stats)
    return lat, center


# ------------------------------------------------------------------------
# eval_level(reso, dirty [L, L, L] bool, val_hr, val_lr) scores the dirty
# points of one level into the [L, L, L] fields in place and returns the
# number of points it scored
LevelFn = Callable[[int, torch.Tensor, torch.Tensor, torch.Tensor], int]


def octree_fields(eval_level: LevelFn, resolution: int, mat: np.ndarray,
                  threshold: float, init_resolution: int, device,
                  silhouette=None, silhouette_calib=None,
                  silhouette_dilate: int = 3, stats: Optional[Dict] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The coarse-to-fine level loop shared by the point (mono) and window
    (runs) evaluators: per level (a ``surs.evaluate.level`` span, counted
    in ``stats["levels"]``), the still-dirty lattice goes to
    ``eval_level``, then prunable cells are filled and the state expands
    to the next level. Returns (hr, lr, points scored)."""
    R = resolution
    schedule = level_schedule(R, init_resolution)
    lats = centers = None
    if silhouette is not None:
        lats, centers = silhouette_masks(
            silhouette, np.asarray(silhouette_calib), R, mat, schedule,
            silhouette_dilate, device, stats)
    L = R // schedule[0]
    val_hr = torch.zeros((L,) * 3, device=device)
    val_lr = torch.zeros((L,) * 3, device=device)
    evald = torch.zeros((L,) * 3, dtype=torch.bool, device=device)
    rfh = torch.zeros_like(evald)
    rfl = torch.zeros_like(evald)
    queries = 0
    for reso in schedule:
        with annotate("surs.evaluate.level", stats, count="levels"):
            dirty = ~evald & ~rfh & ~rfl
            if lats is not None:
                dirty = dirty & lats[reso]
            queries += eval_level(reso, dirty, val_hr, val_lr)
            if reso <= 1:
                break
            val_hr, val_lr, evald, rfh, rfl = _prune_upsample(
                reso, threshold, val_hr, val_lr, evald, rfh, rfl, dirty,
                centers[reso] if centers is not None else None)
    return val_hr, val_lr, queries


def eval_grid_octree(eval_fn: EvalFn, resolution: int, mat: np.ndarray,
                     threshold: float, init_resolution: int = 64,
                     num_samples: int = 50000, device=None,
                     silhouette=None, silhouette_calib=None,
                     silhouette_dilate: int = 3,
                     stats: Optional[Dict] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Evaluate the (hr, lr) occupancy fields over the R^3 grid with the
    index->world affine ``mat``; returns two [R, R, R] float32 tensors
    on ``device`` (CUDA unless named; raises without a GPU).
    ``stats["queries"]`` counts the points evaluated, ``stats["levels"]``
    the levels and ``stats["syncs"]`` the host's waits on the card."""
    R = resolution
    mat = np.asarray(mat)
    device = resolve_device(device)
    with host_wait(stats):
        offset = torch.tensor(mat[:3, 3], dtype=torch.float32, device=device)

    def eval_level(reso, dirty, val_hr, val_lr):
        L = R // reso
        with host_wait(stats):
            idx = torch.nonzero(dirty.reshape(-1)).squeeze(1)
        with host_wait(stats):
            scale = torch.tensor(np.diag(mat[:3, :3]) * reso,
                                 dtype=torch.float32, device=device)
        flat_hr = val_hr.view(-1)
        flat_lr = val_lr.view(-1)
        for c0 in range(0, idx.numel(), num_samples):
            ids = idx[c0:c0 + num_samples]
            ijk = torch.stack([ids // (L * L), (ids // L) % L, ids % L])
            pts = ijk.float() * scale[:, None] + offset[:, None]
            hr, lr = eval_fn(pts)
            flat_hr[ids] = hr
            flat_lr[ids] = lr
        return idx.numel()

    val_hr, val_lr, queries = octree_fields(
        eval_level, R, mat, threshold, init_resolution, device, silhouette,
        silhouette_calib, silhouette_dilate, stats)
    if stats is not None:
        stats["queries"] = stats.get("queries", 0) + queries
    return val_hr, val_lr


# ------------------------------------------------------------------------
def eval_grid_dense(eval_fn: EvalFn, resolution: int, mat: np.ndarray,
                    num_samples: int = 50000, device=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every grid point through ``eval_fn`` in chunks of ``num_samples``
    (``surs_tpu/recon/evaluator.py:1110``) on ``device`` (CUDA unless
    named); the tail chunk is padded with the last index, as the JAX
    package does."""
    R = resolution
    R3 = R ** 3
    mat = np.asarray(mat)
    device = resolve_device(device)
    chunk = min(num_samples, R3)
    hr_out = torch.empty(R3, device=device)
    lr_out = torch.empty(R3, device=device)
    for start in range(0, R3, chunk):
        idx = torch.arange(start, start + chunk, device=device)
        pts = flat_index_to_world(idx.clamp_(max=R3 - 1), R, 1, mat)
        hr, lr = eval_fn(pts)
        n = min(chunk, R3 - start)
        hr_out[start:start + n] = hr[:n]
        lr_out[start:start + n] = lr[:n]
    return hr_out.view(R, R, R), lr_out.view(R, R, R)


# Column-shared dense evaluation (surs_tpu/recon/evaluator.py:1146-1230).
# Under an axis-aligned projection every z sample of a grid column (i, j)
# projects to the same (u, v), so its features are gathered once per
# column and kernel K3 scores the column's R depths.
def dense_cols_separable(calib, mat, tol: float = 1e-6) -> bool:
    """True when (u, v) is independent of the grid k axis and depth is
    independent of (i, j): the precondition for column sharing."""
    calib = np.asarray(calib, np.float64).reshape(-1, 4, 4)[0]
    mat = np.asarray(mat, np.float64)
    A = calib[:3, :3] @ mat[:3, :3]
    return bool(abs(A[0, 2]) < tol and abs(A[1, 2]) < tol
                and abs(A[2, 0]) < tol and abs(A[2, 1]) < tol)


def check_cols_features(cols_weights, feat_lr, feat_hr) -> None:
    if (feat_lr.shape[-1], feat_hr.shape[-1]) != tuple(cols_weights.split):
        raise ValueError(
            f"feature maps of {feat_lr.shape[-1]} / {feat_hr.shape[-1]} "
            f"channels do not match the column weights' split "
            f"{tuple(cols_weights.split)}")


def eval_grid_dense_cols(cols_weights, feat_lr, feat_hr, calib,
                         resolution: int, mat: np.ndarray, load_size: int,
                         z_size: float, stats: Optional[Dict] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense evaluation of every grid point through kernel K3:
    ``cols_weights`` (ops.fused_mlp.ColsWeights), feature maps
    [1, H, W, C] in any dtype, a calibration for which
    :func:`dense_cols_separable` holds. Returns (hr, lr) [R, R, R], the
    flat order ``column * R + k``; ``stats`` counts the host's waits on
    the card."""
    return _dense_cols_rows(cols_weights, feat_lr, feat_hr, calib,
                            resolution, mat, load_size, z_size, 0,
                            resolution, stats)


def eval_grid_dense_cols_sharded(cols_weights, feat_lr, feat_hr, calib,
                                 resolution: int, mat: np.ndarray,
                                 load_size: int, z_size: float, mesh
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-device dense evaluation
    (``surs_tpu/recon/evaluator.py:1233-1320``): the R^2 columns split
    over the mesh's ``points`` axis, rank s scoring columns s R^2/n ...
    (s+1) R^2/n (R/n whole x-rows) through kernel K3 against the whole
    feature maps and weights. No collective runs: each rank returns its
    (hr, lr) x-slab [R/n, R, R], the slab layout that
    ``parallel.sharded_mc`` extracts from (``local=True``);
    ``parallel.gather_field`` joins slabs into the volume."""
    from ..parallel.mesh import POINT_AXIS

    R = resolution
    n = mesh.size(POINT_AXIS)
    if R % n != 0:
        raise ValueError(
            f"column-sharded dense evaluation needs resolution divisible "
            f"by the '{POINT_AXIS}' axis size (whole x-rows per device); "
            f"got R={R} over {n} shards")
    rows = R // n
    return _dense_cols_rows(cols_weights, feat_lr, feat_hr, calib, R, mat,
                            load_size, z_size,
                            mesh.index(POINT_AXIS) * rows, rows)


def _dense_cols_rows(cols_weights, feat_lr, feat_hr, calib, R: int,
                     mat: np.ndarray, load_size: int, z_size: float,
                     row0: int, rows: int, stats: Optional[Dict] = None):
    """x-rows ``row0 ... row0 + rows`` of the dense grid through K3:
    (hr, lr) [rows, R, R]."""
    check_cols_features(cols_weights, feat_lr, feat_hr)
    mat = np.asarray(mat)
    dev = feat_lr.device
    with host_wait(stats):
        calib_t = torch.as_tensor(np.asarray(calib, np.float32),
                                  device=dev).reshape(-1, 4, 4)[:1]
    # the shared depth feature: z depends only on k
    zpts = flat_index_to_world(torch.arange(R, device=dev), R, 1, mat,
                               stats)
    zf = normalize_depth(orthogonal(zpts[None], calib_t)[0, 2, :],
                         load_size, z_size).contiguous()
    # each column at k = 0 (its uv holds for every k)
    cid = torch.arange(row0 * R, (row0 + rows) * R, device=dev)
    xyz = orthogonal(flat_index_to_world(cid * R, R, 1, mat, stats)[None],
                     calib_t)
    mask = in_image_mask(xyz[:, :2, :])[0]
    uv = xyz[:, :2, :].transpose(1, 2)
    x_lr = grid_sample_points(feat_lr, uv)[0]
    x_hr = grid_sample_points(feat_hr, uv)[0]
    hr, lr = fused_dual_mlp_cols(x_lr, x_hr, zf, cols_weights)
    hr.mul_(mask[:, None])
    lr.mul_(mask[:, None])
    return hr.view(rows, R, R), lr.view(rows, R, R)
