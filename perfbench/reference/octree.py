"""Plain occupancy grids of the served meshes' semantics.

``octree_fields``: the coarse-to-fine evaluation that the mono octree
serves (PIFu's ``eval_grid_octree`` with the published SuRS settings):
per level the still-dirty lattice points are evaluated; a cell whose
centre is still dirty and whose 8 corner values span less than the
threshold is filled with (max + min) / 2 and cleared; the dirty state is
shared by the two fields, the fills are per field. Points and cell
centres whose projection misses the dilated silhouette start clean at 0
and are never evaluated.

``line_fields``: the fields along whole grid lines (all depths of a few
columns, or rows along x or y), every point evaluated, as the dense grid
is.

``crossings``: the vertices of marching cubes on a grid (one on every
edge whose ends lie on either side of the level, linearly placed), as
grid coordinates.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# world points [3, N] float32 -> (hr [N], lr [N])
PointFn = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def grid_matrix(R: int, b_min, b_max) -> np.ndarray:
    """Grid index -> world: R points an axis spanning [b_min, b_max)."""
    b_min = np.asarray(b_min, np.float64)
    b_max = np.asarray(b_max, np.float64)
    mat = np.eye(4)
    mat[:3, :3] = np.diag((b_max - b_min) / R)
    mat[:3, 3] = b_min
    return mat


def lattice_points(ijk: torch.Tensor, stride: int, mat: np.ndarray
                   ) -> torch.Tensor:
    """Lattice indices [3, N] (grid coordinates stride * ijk) -> world
    points [3, N] float32."""
    dev = ijk.device
    scale = torch.tensor(np.diag(mat[:3, :3]) * stride, dtype=torch.float32,
                         device=dev)
    offset = torch.tensor(mat[:3, 3], dtype=torch.float32, device=dev)
    return ijk.float() * scale[:, None] + offset[:, None]


def silhouette_hits(mask: torch.Tensor, calib: torch.Tensor, L: int,
                    stride: int, mat: np.ndarray, shift: float,
                    dilate: int) -> torch.Tensor:
    """[L, L, L] bool: lattice points (grid coordinates stride * ijk +
    shift) whose projection lands on the silhouette dilated by ``dilate``
    pixels (bilinear sample > 0)."""
    dev = mask.device
    m = mask.float().reshape(1, 1, *mask.shape[:2])
    if dilate > 0:
        m = F.max_pool2d(m, 2 * dilate + 1, stride=1, padding=dilate)
    ii = torch.arange(L, device=dev)
    # the orthographic calibration projects along the grid's k axis
    ij = torch.stack([ii.repeat_interleave(L), ii.repeat(L),
                      torch.zeros(L * L, dtype=ii.dtype, device=dev)])
    scale = torch.tensor(np.diag(mat[:3, :3]) * stride, dtype=torch.float32,
                         device=dev)
    offset = torch.tensor(mat[:3, 3] + np.diag(mat[:3, :3]) * shift,
                          dtype=torch.float32, device=dev)
    pts = ij.float() * scale[:, None] + offset[:, None]
    xyz = calib[0, :3, :3] @ pts + calib[0, :3, 3:4]
    uv = xyz[:2].T[None, :, None, :]
    hit = F.grid_sample(m, uv, mode="bilinear", padding_mode="zeros",
                        align_corners=True)[0, 0, :, 0] > 0.0
    return hit.reshape(L, L, 1).expand(L, L, L)


def _corner_span(v: torch.Tensor):
    c = torch.stack([v[a:v.shape[0] - 1 + a, b:v.shape[1] - 1 + b,
                       d:v.shape[2] - 1 + d]
                     for a in (0, 1) for b in (0, 1) for d in (0, 1)])
    return c.amin(0), c.amax(0)


def _upsample(x: torch.Tensor, f: int) -> torch.Tensor:
    return x.repeat_interleave(f, 0).repeat_interleave(f, 1) \
        .repeat_interleave(f, 2)


def _pad(c: torch.Tensor) -> torch.Tensor:
    n = c.shape[0]
    out = c.new_zeros((n + 1,) * 3)
    out[:n, :n, :n] = c
    return out


def octree_fields(point_fn: PointFn, R: int, mat: np.ndarray,
                  threshold: float, init_resolution: int, chunk: int,
                  mask=None, calib=None, dilate: int = 3):
    """(hr, lr) [R, R, R] float32 and the number of points evaluated."""
    dev = calib.device if calib is not None else torch.device("cpu")
    strides = []
    s = R // init_resolution
    while s > 0:
        strides.append(s)
        s //= 2
    L = R // strides[0]
    val = [torch.zeros((L,) * 3, device=dev) for _ in range(2)]
    evald = torch.zeros((L,) * 3, dtype=torch.bool, device=dev)
    filled = [torch.zeros_like(evald), torch.zeros_like(evald)]
    queries = 0
    for stride in strides:
        L = R // stride
        dirty = ~evald & ~filled[0] & ~filled[1]
        if mask is not None:
            dirty &= silhouette_hits(mask, calib, L, stride, mat, 0.0,
                                     dilate)
        idx = torch.nonzero(dirty.reshape(-1))[:, 0]
        queries += idx.numel()
        for c0 in range(0, idx.numel(), chunk):
            ids = idx[c0:c0 + chunk]
            ijk = torch.stack([ids // (L * L), (ids // L) % L, ids % L])
            hr, lr = point_fn(lattice_points(ijk, stride, mat))
            val[0].view(-1)[ids] = hr
            val[1].view(-1)[ids] = lr
        if stride == 1:
            break
        # fill the cells that may be, then go to the next lattice
        f = 2
        n = L - 1
        evald = evald | dirty
        center_ok = ~(filled[0] | filled[1])[:n, :n, :n]
        if mask is not None:
            center_ok &= silhouette_hits(mask, calib, n, stride, mat,
                                         stride // 2, dilate)
        coarse = (torch.arange(f * L, device=dev) % f) == 0
        coarse = coarse[:, None, None] & coarse[None, :, None] \
            & coarse[None, None, :]
        for k in range(2):
            vmin, vmax = _corner_span(val[k])
            fill = _pad(center_ok & ((vmax - vmin) < threshold))
            mid = _pad((vmax + vmin) * 0.5)
            kept = _pad(filled[k][:n, :n, :n])
            on_lattice = torch.where(fill, mid, val[k])
            off_lattice = torch.where(fill, mid, torch.where(
                kept, val[k], torch.zeros_like(val[k])))
            val[k] = torch.where(coarse, _upsample(on_lattice, f),
                                 _upsample(off_lattice, f))
            filled[k] = _upsample(kept | fill, f)
        evald = _upsample(evald, f) & coarse
    return val[0], val[1], queries


def line_fields(point_fn: PointFn, cols: torch.Tensor, axis: int, R: int,
                mat: np.ndarray, chunk: int):
    """(hr, lr) [C, R] along the grid lines of ``axis`` through cols
    [C, 2] (the other two grid coordinates, in order)."""
    dev = cols.device
    C = cols.shape[0]
    k = torch.arange(R, device=dev)
    ijk = [cols[:, 0, None].expand(C, R), cols[:, 1, None].expand(C, R)]
    ijk.insert(axis, k[None].expand(C, R))
    pts = lattice_points(torch.stack(ijk).reshape(3, -1), 1, mat)
    hr = torch.empty(C * R, device=dev)
    lr = torch.empty(C * R, device=dev)
    for c0 in range(0, C * R, chunk):
        h, l_ = point_fn(pts[:, c0:c0 + chunk])
        hr[c0:c0 + chunk] = h
        lr[c0:c0 + chunk] = l_
    return hr.view(C, R), lr.view(C, R)


def crossings(field: torch.Tensor, level: float = 0.5):
    """Marching cubes' vertices of ``field`` [..., Z] along its last
    axis (the z edges): one on every edge whose ends lie on either side
    of ``level`` (inside where the value > level), at the linear
    crossing. Returns (the edges' start indices [M, field.dim()] int64,
    the place on each edge t [M] float64)."""
    va = field[..., :-1].double()
    vb = field[..., 1:].double()
    cross = (va > level) != (vb > level)
    idx = torch.nonzero(cross)
    a = va[cross]
    b = vb[cross]
    denom = b - a
    denom = torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12),
                        denom)
    return idx, ((level - a) / denom).clamp(0.0, 1.0)
