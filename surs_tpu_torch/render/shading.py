"""Normals and spherical-harmonics shading (counterpart of
``surs_tpu/render/shading.py``): area-weighted vertex normals and the
9-band SH lighting of the reference's PRT renderer, as torch ops on the
tensors' device. On CUDA ``index_add_`` sums with atomics, so a vertex
normal may differ between runs in its last bits.
"""

from __future__ import annotations

import numpy as np
import torch


def vertex_normals(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Area-weighted per-vertex normals. verts [V, 3], faces [F, 3]."""
    faces = faces.long()
    tri = verts[faces]
    fn = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    vn = torch.zeros_like(verts)
    for k in range(3):
        vn.index_add_(0, faces[:, k], fn)
    norm = torch.linalg.norm(vn, dim=1, keepdim=True)
    return vn / torch.clamp(norm, min=1e-12)


def sh9_basis(n: torch.Tensor) -> torch.Tensor:
    """Real SH basis up to band 2 at directions n [?, 3] -> [?, 9]."""
    x, y, z = n[:, 0], n[:, 1], n[:, 2]
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),         # Y00
        0.4886025119029199 * y,                          # Y1-1
        0.4886025119029199 * z,                          # Y10
        0.4886025119029199 * x,                          # Y11
        1.0925484305920792 * x * y,                      # Y2-2
        1.0925484305920792 * y * z,                      # Y2-1
        0.31539156525252005 * (3.0 * z * z - 1.0),       # Y20
        1.0925484305920792 * x * z,                      # Y21
        0.5462742152960396 * (x * x - y * y),            # Y22
    ], dim=1)


def sh_shading(normals: torch.Tensor, sh_coeffs) -> torch.Tensor:
    """Irradiance per vertex from 9-band lighting coefficients.

    sh_coeffs: [9] or [9, 3] (per-channel). Returns [V] or [V, 3].
    """
    basis = sh9_basis(normals)                            # [V, 9]
    return basis @ torch.as_tensor(np.asarray(sh_coeffs, np.float32),
                                   device=basis.device)


def default_lighting() -> np.ndarray:
    """A soft studio-like SH environment (ambient + frontal key)."""
    sh = np.zeros(9, np.float32)
    sh[0] = 2.5            # ambient
    sh[2] = -0.8           # light from -z (toward camera)
    sh[1] = 0.3
    return sh


def lambert_shading(normals: torch.Tensor, light_dir, ambient: float = 0.3
                    ) -> torch.Tensor:
    light = torch.as_tensor(np.asarray(light_dir, np.float32),
                            device=normals.device)
    light = light / torch.linalg.norm(light)
    return ambient + (1 - ambient) * torch.clamp(normals @ light, min=0.0)
