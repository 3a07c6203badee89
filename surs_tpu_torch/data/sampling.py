"""Training point sampling and occupancy / displacement labels (the
port's copy of ``surs_tpu/data/sampling.py``):

  * 4N area-weighted surface points of the HR mesh with N(0, sigma)
    jitter, plus N/4 uniform points of the box, shuffled;
  * inside / outside against the HR and the LR mesh by winding number
    (``ops/containment.py``: the hand-written kernel on the card);
  * N/2 inside + N/2 outside points a mesh (fewer inside when fewer
    are);
  * displacement labels: the HR occupancy at the LR-ordered samples;
  * the color branch's supervision from per-vertex colors
    (``sample_surface_colors``).

The ``np.random.Generator`` calls are the JAX package's, in its order, so
one seed gives the same samples.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np

from ..ops.containment import contains


@dataclass
class MeshData:
    verts: np.ndarray   # [V, 3] float32
    faces: np.ndarray   # [F, 3] int64

    _face_areas: Optional[np.ndarray] = None

    def face_areas(self) -> np.ndarray:
        if self._face_areas is None:
            tri = self.verts[self.faces]
            self._face_areas = 0.5 * np.linalg.norm(
                np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]),
                axis=1)
        return self._face_areas


def sample_surface(mesh: MeshData, n: int,
                   rng: np.random.Generator) -> np.ndarray:
    """n area-weighted uniform points on the surface [n, 3] float64
    (``trimesh.sample.sample_surface``'s distribution)."""
    areas = mesh.face_areas()
    probs = areas / areas.sum()
    fidx = rng.choice(len(probs), size=n, p=probs)
    tri = mesh.verts[mesh.faces[fidx]]          # [n, 3, 3]
    # uniform barycentric coordinates by the square-root trick
    r1 = np.sqrt(rng.random(n))
    r2 = rng.random(n)
    w0 = 1.0 - r1
    w1 = r1 * (1.0 - r2)
    w2 = r1 * r2
    return (w0[:, None] * tri[:, 0] + w1[:, None] * tri[:, 1]
            + w2[:, None] * tri[:, 2]).astype(np.float64)


def sample_surface_colors(mesh: MeshData, vert_colors: np.ndarray, n: int,
                          sigma: float, rng: np.random.Generator
                          ) -> Dict[str, np.ndarray]:
    """Color supervision from per-vertex colors in [0, 1]: n area-weighted
    surface points moved along their face normal by N(0, sigma), with the
    barycentric mix of the face's vertex colors mapped to [-1, 1].
    Returns {color_samples [3, n], rgbs [3, n]} float32. The draws are
    ``surs_tpu/data/sampling.py:70-95``'s, in its order."""
    areas = mesh.face_areas()
    probs = areas / areas.sum()
    fidx = rng.choice(len(probs), size=n, p=probs)
    tri = mesh.verts[mesh.faces[fidx]]                  # [n, 3, 3]
    col = np.asarray(vert_colors, np.float64)[mesh.faces[fidx]]
    r1 = np.sqrt(rng.random(n))
    r2 = rng.random(n)
    w = np.stack([1.0 - r1, r1 * (1.0 - r2), r1 * r2], axis=1)  # [n, 3]
    pts = np.einsum("nk,nkd->nd", w, tri)
    rgb = np.einsum("nk,nkd->nd", w, col)
    normals = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    normals /= np.maximum(np.linalg.norm(normals, axis=1, keepdims=True),
                          1e-12)
    offset = rng.normal(0.0, sigma, (n, 1))
    samples = pts + offset * normals
    return {"color_samples": samples.T.astype(np.float32),
            "rgbs": (2.0 * rgb - 1.0).T.astype(np.float32)}


def sample_points_and_labels(
        mesh_hr: MeshData, mesh_lr: MeshData, num_sample_inout: int,
        sigma: float, b_min: np.ndarray, b_max: np.ndarray,
        rng: np.random.Generator, contains_fn: Optional[Callable] = None,
        device=None) -> Dict[str, np.ndarray]:
    """samples_HR / samples_LR [3, N] and labels_HR / labels_disp [1, N]
    float32. ``contains_fn(points, mesh)`` -> bool [P] labels the points;
    by default ``ops.containment.contains`` on ``device`` (CUDA unless
    named)."""
    if contains_fn is None:
        def contains_fn(pts, m):
            return contains(pts, m.verts, m.faces, device)
    N = num_sample_inout

    surface = sample_surface(mesh_hr, 4 * N, rng)
    pts = surface + rng.normal(scale=sigma, size=surface.shape)
    length = np.asarray(b_max, float) - np.asarray(b_min, float)
    uniform = rng.random((N // 4, 3)) * length + np.asarray(b_min, float)
    pts = np.concatenate([pts, uniform], axis=0)
    rng.shuffle(pts)

    inside_hr = np.asarray(contains_fn(pts, mesh_hr))
    inside_lr = np.asarray(contains_fn(pts, mesh_lr))

    all_idx = np.arange(pts.shape[0])

    def split_truncate(inside_mask):
        ins = all_idx[inside_mask]
        outs = all_idx[~inside_mask]
        nin = ins.shape[0]
        if nin > N // 2:
            return ins[:N // 2], outs[:N // 2]
        return ins, outs[:N - nin]

    ins_hr, outs_hr = split_truncate(inside_hr)
    ins_lr, outs_lr = split_truncate(inside_lr)

    idx_hr = np.concatenate([ins_hr, outs_hr])
    idx_lr = np.concatenate([ins_lr, outs_lr])
    labels_hr = np.concatenate(
        [np.ones((1, ins_hr.shape[0])), np.zeros((1, outs_hr.shape[0]))],
        axis=1)
    # displacement labels: the HR occupancy at the LR-ordered samples
    labels_disp = inside_hr[idx_lr].astype(np.float64)[None, :]

    return {
        "samples_HR": pts[idx_hr].T.astype(np.float32),
        "samples_LR": pts[idx_lr].T.astype(np.float32),
        "labels_HR": labels_hr.astype(np.float32),
        "labels_disp": labels_disp.astype(np.float32),
    }
