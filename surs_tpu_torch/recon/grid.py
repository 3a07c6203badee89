"""Reconstruction grid math (counterpart of ``surs_tpu/recon/grid.py``)."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..utils.profiling import host_wait


def grid_matrix(res: Tuple[int, int, int], b_min, b_max) -> np.ndarray:
    """4x4 affine: integer grid index -> world coordinate, spanning
    [b_min, b_max) with res points per axis."""
    b_min = np.asarray(b_min, dtype=np.float64)
    b_max = np.asarray(b_max, dtype=np.float64)
    length = b_max - b_min
    mat = np.eye(4)
    for a in range(3):
        mat[a, a] = length[a] / res[a]
    mat[:3, 3] = b_min
    return mat


def flat_index_to_world(flat_idx: torch.Tensor, lattice_size: int,
                        stride: int, mat: np.ndarray,
                        stats: Optional[Dict] = None) -> torch.Tensor:
    """Flat indices [N] into an L^3 lattice whose grid coordinates are
    ``stride * (i, j, k)`` -> [3, N] float32 world points, on the
    indices' device (``surs_tpu/recon/grid.py:63``). ``stats`` counts
    the copies of the affine's terms as host waits."""
    L = lattice_size
    k = flat_idx % L
    j = (flat_idx // L) % L
    i = flat_idx // (L * L)
    ijk = torch.stack([i, j, k]).to(torch.float32) * float(stride)
    dev = flat_idx.device
    with host_wait(stats):
        scale = torch.tensor(np.diag(mat[:3, :3]), dtype=torch.float32,
                             device=dev)
    with host_wait(stats):
        offset = torch.tensor(mat[:3, 3], dtype=torch.float32, device=dev)
    return ijk * scale[:, None] + offset[:, None]


def require_diagonal(mat: np.ndarray, context: str) -> np.ndarray:
    """The evaluators build world points from ``diag(mat[:3, :3])``
    alone (``flat_index_to_world``), so a rotating or shearing grid
    transform would be dropped by the fields and applied to the
    vertices: raise instead (``surs_tpu/recon/grid.py:33``)."""
    rot = np.asarray(mat[:3, :3], np.float64)
    if not np.allclose(rot, np.diag(np.diag(rot)), atol=1e-12):
        raise ValueError(
            f"{context} supports only axis-aligned (diagonal) grid "
            "transforms: the evaluators build coordinates from diag(mat); "
            f"got off-diagonal terms {rot - np.diag(np.diag(rot))!r}")
    return mat
