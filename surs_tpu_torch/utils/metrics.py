"""Mesh-fidelity metrics: Chamfer, point-to-surface, projected normal
consistency (counterpart of ``surs_tpu/utils/metrics.py``).

Distances are an exact brute-force nearest neighbour over surface
samples, the pairwise squared distances ``|a|^2 + |b|^2 - 2ab`` in chunks
of 4,096 query points, as the JAX package computes them. The expansion
runs in float64: for points of norm about 1 a TF32 product would lose
about 1e-3 in a squared distance (0.03 in a distance, the size of the
Chamfer being measured), and float64 makes the metric independent of the
caller's ``torch.backends.cuda.matmul.allow_tf32``. Surface samples come
from the port's ``data/sampling.sample_surface`` with the same numpy
generator calls, so a seed draws the JAX package's points.

Entry points run on CUDA unless ``device`` names another device; they
raise without a GPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import resolve_device
from ..data.sampling import MeshData, sample_surface

# faces rasterized at once by projected_normal_error: the rasterizer's
# F x patch^2 candidate tensors take about 6 GB at 400,000 faces
RASTER_CHUNK = 400_000


def _nn_dist_sq(a: torch.Tensor, b: torch.Tensor, chunk: int = 4096
                ) -> torch.Tensor:
    """For each point of a [N, 3], the squared distance to its nearest
    point of b [M, 3], as float64, clamped at 0."""
    a = a.double()
    b = b.double()
    b_sq = torch.sum(b * b, dim=1)
    mins = []
    for a_chunk in torch.split(a, chunk):
        d = (torch.sum(a_chunk * a_chunk, dim=1)[:, None] + b_sq[None, :]
             - 2.0 * a_chunk @ b.T)
        mins.append(torch.amin(d, dim=1))
    return torch.clamp(torch.cat(mins), min=0.0)


def chamfer_distance(mesh_a: MeshData, mesh_b: MeshData,
                     n_samples: int = 10000, seed: int = 1991,
                     device=None) -> Tuple[float, float, float]:
    """(chamfer, a->b, b->a) mean point-to-point distances between
    surface samples of two meshes (the bidirectional Chamfer-L1
    protocol)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    pa = torch.as_tensor(sample_surface(mesh_a, n_samples, rng).astype(
        np.float32), device=device)
    pb = torch.as_tensor(sample_surface(mesh_b, n_samples, rng).astype(
        np.float32), device=device)
    d_ab = float(torch.mean(torch.sqrt(_nn_dist_sq(pa, pb))))
    d_ba = float(torch.mean(torch.sqrt(_nn_dist_sq(pb, pa))))
    return 0.5 * (d_ab + d_ba), d_ab, d_ba


def point_to_surface(points: np.ndarray, mesh: MeshData,
                     n_surface: int = 50000, seed: int = 1991,
                     device=None) -> float:
    """Mean distance from ``points`` to a dense surface sampling of
    ``mesh`` (P2S proxy via sampled surface)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    surf = torch.as_tensor(sample_surface(mesh, n_surface, rng).astype(
        np.float32), device=device)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=device)
    return float(torch.mean(torch.sqrt(_nn_dist_sq(pts, surf))))


def _subdivide_for_raster(uvz: np.ndarray, attrs: np.ndarray,
                          faces: np.ndarray, res: int, max_px: float,
                          max_rounds: int = 8):
    """4-way midpoint-split faces whose projected bbox exceeds
    ``max_px`` pixels, so every face fits the rasterizer's per-face
    candidate patch. Attributes are midpoint-averaged (== barycentric
    interpolation of the original surface). Vertices are duplicated,
    not welded — harmless for rasterization."""
    px_per_uv = 0.5 * (res - 1)
    for _ in range(max_rounds):
        tri = uvz[faces]                                   # [F, 3, 3]
        ext = (tri[:, :, :2].max(axis=1)
               - tri[:, :, :2].min(axis=1)).max(axis=1) * px_per_uv
        big = ext > max_px
        if not np.any(big):
            break
        fb = faces[big]
        base = uvz.shape[0]
        m01 = 0.5 * (uvz[fb[:, 0]] + uvz[fb[:, 1]])
        m12 = 0.5 * (uvz[fb[:, 1]] + uvz[fb[:, 2]])
        m20 = 0.5 * (uvz[fb[:, 2]] + uvz[fb[:, 0]])
        a01 = 0.5 * (attrs[fb[:, 0]] + attrs[fb[:, 1]])
        a12 = 0.5 * (attrs[fb[:, 1]] + attrs[fb[:, 2]])
        a20 = 0.5 * (attrs[fb[:, 2]] + attrs[fb[:, 0]])
        n = fb.shape[0]
        i01 = base + np.arange(n)
        i12 = base + n + np.arange(n)
        i20 = base + 2 * n + np.arange(n)
        uvz = np.concatenate([uvz, m01, m12, m20], axis=0)
        attrs = np.concatenate([attrs, a01, a12, a20], axis=0)
        quads = np.concatenate([
            np.stack([fb[:, 0], i01, i20], axis=1),
            np.stack([i01, fb[:, 1], i12], axis=1),
            np.stack([i20, i12, fb[:, 2]], axis=1),
            np.stack([i01, i12, i20], axis=1)], axis=0)
        faces = np.concatenate([faces[~big], quads], axis=0)
    return uvz, attrs, faces


def projected_normal_error(mesh_rec: MeshData, mesh_gt: MeshData,
                           calib: Optional[np.ndarray] = None,
                           res: int = 512, device=None
                           ) -> Tuple[float, float]:
    """The paper's third quality metric (normal consistency, beside
    Chamfer / P2S): render world-space unit vertex normals of both meshes
    from the eval view with the rasterizer and compare the normal maps.

    Returns ``(l2, cos)``: mean L2 distance between the two normal maps
    over the UNION of their silhouettes (mask mismatches count at full
    error, the PIFu protocol), and mean cosine similarity over the
    INTERSECTION (orientation agreement alone).

    ``calib``: 4x4 projection (default: the fixed eval calibration
    diag(2, -2, 2, 1), ``recon/pipeline.eval_calibration``).
    """
    from ..render import rasterize, vertex_normals

    device = resolve_device(device)
    if calib is None:
        calib = np.diag([2.0, -2.0, 2.0, 1.0]).astype(np.float32)
    calib = np.asarray(calib, np.float32).reshape(4, 4)
    patch = 16

    def normal_map(mesh: MeshData):
        v = np.asarray(mesh.verts, np.float32)
        f = np.asarray(mesh.faces, np.int64)
        vn = vertex_normals(torch.as_tensor(v, device=device),
                            torch.as_tensor(f, device=device)).cpu().numpy()
        uvz = v @ calib[:3, :3].T + calib[:3, 3]
        # the rasterizer drops pixels beyond a patch x patch window per
        # face: split any face projecting larger than that (a no-op for
        # marching-cubes output; matters for coarse GT meshes)
        uvz, vn, f = _subdivide_for_raster(uvz, vn, f, res,
                                           max_px=patch - 2)
        # megaface meshes render in chunks of faces, z-merged: the
        # front-most depth wins, a tie keeps the earlier chunk's (smaller)
        # face id
        img = mask = depth = None
        uvz_t = torch.as_tensor(uvz, device=device)
        vn_t = torch.as_tensor(vn, device=device)
        f_t = torch.as_tensor(f, device=device)
        for f0 in range(0, max(f.shape[0], 1), RASTER_CHUNK):
            img_c, mask_c, depth_c = rasterize(
                uvz_t, f_t[f0:f0 + RASTER_CHUNK], vn_t, res=res,
                patch=patch)
            if img is None:
                img, mask, depth = img_c, mask_c, depth_c
            else:
                win = depth_c < depth
                img = torch.where(win[..., None], img_c, img)
                mask = mask | mask_c
                depth = torch.where(win, depth_c, depth)
        # re-normalize the interpolated normals pixel-wise
        n = img / torch.clamp(torch.linalg.norm(img, dim=-1, keepdim=True),
                              min=1e-12)
        return n * mask[..., None], mask

    na, ma = normal_map(mesh_rec)
    nb, mb = normal_map(mesh_gt)
    union = ma | mb
    inter = ma & mb
    diff = torch.linalg.norm(na - nb, dim=-1)
    l2 = torch.sum(torch.where(union, diff, 0.0)) \
        / torch.clamp(torch.sum(union), min=1)
    cos = torch.sum(torch.where(inter, torch.sum(na * nb, dim=-1), 0.0)) \
        / torch.clamp(torch.sum(inter), min=1)
    return float(l2), float(cos)
