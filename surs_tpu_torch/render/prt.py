"""Precomputed radiance transfer (PRT) shading (counterpart of
``surs_tpu/render/prt.py``).

The reference renderer shades its training images with per-vertex
spherical-harmonic transfer vectors: ``sum_i prt[i] * SHCoeffs[i]``
(``prt.fs``'s ``evaluateLightingModelPRT``), the transfer rotated into
each view's light frame. Here, as in the JAX package:

  * :func:`irradiance_basis`: ``evaluateH``, the analytic cosine-convolved
    SH9 basis (its exact constants);
  * :func:`compute_prt`: shadowed diffuse transfer. The mesh is voxelized
    once by winding number (``ops/containment.contains``: the hand-written
    kernel ``csrc/winding_number.cu`` on the card), and each (vertex,
    direction) ray samples the occupancy grid at ``n_steps`` distances
    (:func:`visibility`, plain torch: the JAX package's is a ``lax.scan``
    that XLA compiles, not a Pallas kernel);
  * :func:`sh_rotation_matrix`: the 9 x 9 band-limited rotation, fitted by
    least squares over a Fibonacci direction set (numpy);
  * :func:`prt_shading`: the fragment shader's contraction.

Tensors live on an explicit device: CUDA unless the caller names one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import resolve_device
from .shading import sh9_basis, vertex_normals

# Per-band ratio conv / raw between the cosine-convolved irradiance basis
# (evaluateH amplitudes) and the raw Y9 basis: A_hat_l = [pi, 2 pi / 3,
# pi / 4]. Lighting tuned for one basis converts to the other per band.
RAW_TO_CONV = np.array([np.pi] + [2.0 * np.pi / 3.0] * 3
                       + [np.pi / 4.0] * 5, np.float32)

# voxelize_occupancy's grid points a containment call
VOXEL_CHUNK = 65536


def irradiance_basis(n: torch.Tensor) -> torch.Tensor:
    """``evaluateH``: the clamped-cosine-convolved SH9 basis at unit
    normals ``n`` [V, 3] -> [V, 9], in prt.fs's index order (Y00, Y1-1,
    Y10, Y11, Y2-2, Y2-1, Y20, Y21, Y22 with (x, y, z) = n)."""
    c1, c2, c3, c4, c5 = 0.429043, 0.511664, 0.743125, 0.886227, 0.247708
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    return torch.stack([
        torch.full_like(x, c4),
        2.0 * c2 * y,
        2.0 * c2 * z,
        2.0 * c2 * x,
        2.0 * c1 * x * y,
        2.0 * c1 * y * z,
        c3 * z * z - c5,
        2.0 * c1 * z * x,
        c1 * (x * x - y * y),
    ], dim=-1)


def fibonacci_sphere(n: int) -> np.ndarray:
    """n near-uniform unit directions (spherical Fibonacci lattice)."""
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.pi * (3.0 - np.sqrt(5.0)) * i
    z = 1.0 - 2.0 * i / n
    r = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    return np.stack([r * np.cos(phi), r * np.sin(phi), z],
                    axis=1).astype(np.float32)


def grid_points(verts: np.ndarray, grid: int, pad: float = 0.03
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The voxel centres of a mesh's padded bounding box: (points
    [grid^3, 3] float32 in ``meshgrid(indexing="ij")`` order, b_min [3],
    cell [3])."""
    v = np.asarray(verts, np.float32)
    b_min = v.min(axis=0) - pad
    b_max = v.max(axis=0) + pad
    cell = (b_max - b_min) / grid
    g = (np.arange(grid, dtype=np.float32) + 0.5)
    pts = np.stack(np.meshgrid(g * cell[0] + b_min[0],
                               g * cell[1] + b_min[1],
                               g * cell[2] + b_min[2],
                               indexing="ij"), -1).reshape(-1, 3)
    return pts, b_min, cell


def voxelize_occupancy(verts: np.ndarray, faces: np.ndarray,
                       grid: int = 96, pad: float = 0.03, device=None
                       ) -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """Solid occupancy grid of a mesh by winding numbers, on ``device``
    (CUDA unless named). Returns (occ [G, G, G] bool tensor, b_min [3],
    cell [3]): grid point (i, j, k) sits at ``b_min + (ijk + 0.5) *
    cell``."""
    from ..ops.containment import contains

    device = resolve_device(device)
    pts, b_min, cell = grid_points(verts, grid, pad)
    v = np.asarray(verts, np.float32)
    f = np.asarray(faces)
    occ = np.zeros((grid ** 3,), bool)
    for s in range(0, pts.shape[0], VOXEL_CHUNK):
        occ[s:s + VOXEL_CHUNK] = contains(pts[s:s + VOXEL_CHUNK], v, f,
                                          device)
    return (torch.from_numpy(occ.reshape(grid, grid, grid)).to(device),
            b_min, cell)


def _fma32(x: np.ndarray, y, z) -> np.ndarray:
    """float32 x * y + z rounded once (the product of two float32 values
    is exact in float64)."""
    return (x.astype(np.float64) * np.float64(y)
            + np.asarray(z, np.float64)).astype(np.float32)


def march_distances(t0: float, t1: float, n_steps: int) -> np.ndarray:
    """The ray's sample distances, float32, as the JAX package's
    ``jnp.linspace(t0, t1, n_steps, dtype=float32)`` computes them once
    XLA has compiled its formula ``t0 * (1 - i / div) + t1 * (i / div)``:
    the division becomes a product with div's float32 reciprocal r, and
    the products contract into FMAs, ``fma(i, t1 * r, t0 * fma(-i, r,
    1))``; the last distance is ``t1``. The same float32 distance puts a
    sample in the same voxel."""
    a, b = np.float32(t0), np.float32(t1)
    if n_steps <= 1:
        return np.full((max(n_steps, 0),), a, np.float32)
    div = n_steps - 1
    r = np.float32(1) / np.float32(div)
    i = np.arange(div, dtype=np.float32)
    s = _fma32(-i, r, 1.0)
    out = _fma32(i, b * r, a * s)
    return np.concatenate([out, [b]]).astype(np.float32)


def visibility(origins: torch.Tensor, dirs: torch.Tensor,
               occ: torch.Tensor, b_min: torch.Tensor,
               inv_cell: torch.Tensor, t0: float, t1: float,
               n_steps: int = 48) -> torch.Tensor:
    """V [Nv, D] bool: True where the ray ``origin + t * dir`` (t at
    :func:`march_distances`) never enters the solid. A loop over the
    sample distances OR-ing the hits of an [Nv, D] boolean, on the
    tensors' device (``surs_tpu/render/prt.py:_visibility``)."""
    G = occ.shape[0]
    occ_f = occ.reshape(-1)
    ts = march_distances(t0, t1, n_steps).tolist()
    occluded = torch.zeros((origins.shape[0], dirs.shape[0]),
                           dtype=torch.bool, device=origins.device)
    o = origins[:, None, :]
    d = dirs[None, :, :]
    for t in ts:
        p = o + t * d                                  # [Nv, D, 3]
        ijk = torch.floor((p - b_min) * inv_cell).to(torch.int32)
        inb = ((ijk >= 0) & (ijk < G)).all(dim=-1)
        ijk = ijk.clamp(0, G - 1).long()
        gid = (ijk[..., 0] * G + ijk[..., 1]) * G + ijk[..., 2]
        occluded |= occ_f[gid] & inb
    return ~occluded


def march_plan(verts: np.ndarray, cell: np.ndarray, eps_cells: float,
               n_steps: Optional[int]) -> Tuple[float, float, int]:
    """(t0, t1, n_steps) of compute_prt's rays: start ``eps_cells`` voxel
    diagonals off the surface, end past the bounding box's diagonal, and
    by default march below a voxel's smallest side (a coarser stride
    tunnels through occluders a few voxels thick)."""
    diag = float(np.linalg.norm(cell))
    t0 = eps_cells * diag
    t1 = float(np.linalg.norm(verts.max(0) - verts.min(0))) + 2 * diag
    if n_steps is None:
        n_steps = int(np.ceil((t1 - t0) / (0.7 * float(cell.min()))))
    return t0, t1, n_steps


def compute_prt(verts: np.ndarray, faces: np.ndarray,
                n_dirs: int = 128, grid: int = 96,
                n_steps: Optional[int] = None, eps_cells: float = 2.0,
                vert_chunk: int = 4096,
                normals: Optional[np.ndarray] = None,
                device=None) -> np.ndarray:
    """Per-vertex shadowed diffuse transfer vectors [V, 9] float32:

        T_i(v) = (4 pi / N) sum_w Y_i(w) V(v, w) max(n_v . w, 0)

    so an unoccluded vertex's T is :func:`irradiance_basis` (n) up to
    Monte-Carlo error. Rays start ``eps_cells`` voxel diagonals off the
    surface, along the normal. Runs on ``device`` (CUDA unless named);
    ``normals`` default to the port's area-weighted vertex normals."""
    device = resolve_device(device)
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces)
    verts_t = torch.from_numpy(verts).to(device)
    if normals is None:
        normals_t = vertex_normals(
            verts_t, torch.from_numpy(faces.astype(np.int64)).to(device))
    else:
        normals_t = torch.from_numpy(np.array(normals, np.float32)).to(
            device)
    occ, b_min, cell = voxelize_occupancy(verts, faces, grid=grid,
                                          device=device)
    t0, t1, n_steps = march_plan(verts, cell, eps_cells, n_steps)

    dirs = torch.from_numpy(fibonacci_sphere(n_dirs)).to(device)
    Y = sh9_basis(dirs)                                   # [D, 9]
    inv_cell = torch.from_numpy((1.0 / cell).astype(np.float32)).to(device)
    b_min_t = torch.from_numpy(b_min.astype(np.float32)).to(device)

    out = torch.empty((verts.shape[0], 9), dtype=torch.float32,
                      device=device)
    for s in range(0, verts.shape[0], vert_chunk):
        v = verts_t[s:s + vert_chunk]
        n = normals_t[s:s + vert_chunk]
        # off the surface along the normal too, so the vertex's own
        # voxels do not occlude grazing directions
        orig = v + t0 * n
        vis = visibility(orig, dirs, occ, b_min_t, inv_cell, t0, t1,
                         n_steps=n_steps)                 # [Nv, D]
        geom = torch.clamp(n @ dirs.T, min=0.0)           # [Nv, D]
        w = vis.to(torch.float32) * geom
        out[s:s + vert_chunk] = (4.0 * np.pi / n_dirs) * (w @ Y)
    return out.cpu().numpy()


def sh_rotation_matrix(R: np.ndarray, n_fit: int = 256) -> np.ndarray:
    """9 x 9 matrix M with SH9(R @ w) == SH9(w) @ M.T for band-limited
    functions: rotating a transfer or light vector c is ``M @ c``
    (prt.vs's shader rotation, done on the host). Least squares over a
    Fibonacci set, exact for bands <= 2; numpy, float32 result."""
    d = fibonacci_sphere(n_fit)
    Y0 = sh9_basis(torch.from_numpy(d)).numpy()           # [K, 9]
    Yr = sh9_basis(torch.from_numpy(
        d @ np.asarray(R, np.float32))).numpy()
    # f_rot(w) = f(R^-1 w); with rows d: the original basis at
    # R^-1 d == d @ R (orthonormal R)
    M, *_ = np.linalg.lstsq(Y0, Yr, rcond=None)
    return M.T.astype(np.float32)


def prt_shading(prt: torch.Tensor, sh_coeffs) -> torch.Tensor:
    """``evaluateLightingModelPRT``: [V, 9] x ([9] or [9, 3]) -> [V] or
    [V, 3] irradiance, on ``prt``'s device."""
    return prt @ torch.as_tensor(np.asarray(sh_coeffs, np.float32),
                                 device=prt.device)
