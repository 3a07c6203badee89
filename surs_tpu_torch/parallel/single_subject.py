"""One subject over a mesh axis, end to end (counterpart of
``surs_tpu/parallel/single_subject.py``): the column-sharded dense
evaluation through kernel K3 (``recon.evaluator.
eval_grid_dense_cols_sharded``) leaves each rank its x-slab of both
fields, which is the slab the sharded extraction (``sharded_mc``) meshes,
so the volumes are never gathered: only the halo planes and the slabs'
meshes move between ranks. The HR and LR extractions are staged so that
both begin before either syncs, as in ``Reconstructor.extract_pair``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..recon.evaluator import (dense_cols_separable,
                               eval_grid_dense_cols_sharded)
from ..recon.grid import grid_matrix, require_diagonal
from .mesh import POINT_AXIS, Mesh


def reconstruct_subject_sharded(cols_weights, feat_lr, feat_hr, calib,
                                resolution: int, b_min, b_max,
                                load_size: int, z_size: float, mesh: Mesh,
                                axis: str = POINT_AXIS, level: float = 0.5,
                                algorithm: str = "cubes",
                                cell_chunk: int = 1 << 16,
                                transform: Optional[np.ndarray] = None
                                ) -> Optional[Tuple[np.ndarray, np.ndarray,
                                                    np.ndarray, np.ndarray]]:
    """Dense column-sharded evaluation chained into slab-sharded
    extraction on ``mesh``. ``cols_weights``: ops.fused_mlp.ColsWeights;
    ``feat_lr`` / ``feat_hr``: the whole [1, H, W, C] maps on every rank.
    Returns (verts_hr, faces_hr, verts_lr, faces_lr) in world coordinates
    on the axis' rank 0 (the single-device dense path's meshes, vertex
    and face order aside) and None on the other ranks."""
    from ..recon.pipeline import Reconstructor

    R = resolution
    mat = grid_matrix((R,) * 3, b_min, b_max)
    if transform is not None:
        mat = require_diagonal(np.asarray(transform) @ mat,
                               "reconstruct_subject_sharded(transform=)")
    if not dense_cols_separable(calib, mat):
        raise ValueError("sharded single-subject reconstruction requires "
                         "a column-separable calibration (the production "
                         "eval calib diag(2,-2,2,1) qualifies)")
    slab_hr, slab_lr = eval_grid_dense_cols_sharded(
        cols_weights, feat_lr, feat_hr, calib, R, mat, load_size, z_size,
        mesh)
    # every rank takes both items: each one's finish is collective
    pairs = list(Reconstructor.extract_pair(
        slab_hr, slab_lr, mat, level=level, mc_backend="sharded",
        mc_caps=dict(mesh=mesh, axis=axis, algorithm=algorithm,
                     cell_chunk=cell_chunk, local=True)))
    if pairs[0] is None:
        return None
    return pairs[0] + pairs[1]
