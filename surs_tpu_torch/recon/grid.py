"""Reconstruction grid math (counterpart of ``surs_tpu/recon/grid.py``)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


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
