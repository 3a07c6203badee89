"""Point-sharded and per-subject octree evaluation across a mesh
(counterpart of ``surs_tpu/parallel/batch_recon.py``).

* :func:`shard_eval_fn_over_points`: one subject, each chunk of query
  points split over the ``points`` ranks; each rank scores its part (on
  the card through kernel K1 when the evaluator is the query of
  ``recon.pipeline``) and the parts are all-gathered, so every rank holds
  every chunk's values and runs the same octree.
* :class:`ShardedReconstructor`: B subjects, one a ``data`` rank; each
  rank runs the octree's level and prune steps
  (``recon/evaluator.py``) on its own subject, with no collective until
  the fields or the meshes are gathered.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from ..recon.evaluator import EvalFn, eval_grid_octree
from ..recon.grid import grid_matrix
from ..recon.marching import extract_isosurface
from .mesh import DATA_AXIS, POINT_AXIS, Mesh


def shard_eval_fn_over_points(eval_fn: EvalFn, mesh: Mesh) -> EvalFn:
    """``eval_fn`` ([3, C] points -> (hr [C], lr [C])) with each call's
    points split over ``mesh``'s ``points`` ranks in equal contiguous
    parts; every rank gets the whole (hr, lr). A chunk that does not
    divide by the axis size is padded with its last point (the JAX
    package's chunks are all ``num_samples`` long, which must divide)."""
    comm = mesh.comm(POINT_AXIS)
    n = comm.size

    def wrapped(points: torch.Tensor):
        C = points.shape[1]
        per = -(-C // n)
        if per * n != C:
            points = torch.cat(
                [points, points[:, -1:].expand(3, per * n - C)], dim=1)
        mine = points[:, comm.rank * per:(comm.rank + 1) * per]
        hr, lr = eval_fn(mine.contiguous())
        return (torch.cat(comm.all_gather(hr.contiguous()))[:C],
                torch.cat(comm.all_gather(lr.contiguous()))[:C])

    return wrapped


def _take(tree, b: int):
    """Row ``b`` of every leaf of a dict / list / tuple of arrays."""
    if isinstance(tree, dict):
        return {k: _take(v, b) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_take(v, b) for v in tree)
    return tree[b]


class ShardedReconstructor:
    """Evaluate B subjects' occupancy fields, one subject a ``data``
    rank. ``eval_fn(points [3, C], ctx) -> (hr [C], lr [C])``; the
    ``ctx`` given to :meth:`evaluate` carries a leading batch axis of
    size B == the ``data`` axis size on every leaf, and rank b scores
    with its row b."""

    def __init__(self, eval_fn: Callable[[torch.Tensor, Any],
                                         Tuple[torch.Tensor, torch.Tensor]],
                 mesh: Mesh, resolution: int, b_min, b_max,
                 threshold: float = 0.05, init_resolution: int = 64,
                 num_samples: int = 50000):
        self.eval_fn = eval_fn
        self.mesh = mesh
        self.R = resolution
        self.threshold = threshold
        self.init_resolution = init_resolution
        self.num_samples = num_samples
        self.mat = grid_matrix((resolution,) * 3, b_min, b_max)
        self.n_data = mesh.size(DATA_AXIS)

    def evaluate(self, ctx: Any, gather: bool = False, local: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """This rank's subject's (sdf_hr, sdf_lr) [R, R, R] on the mesh's
        device; ``gather=True``: every subject's, [B, R, R, R], on every
        rank of the ``data`` axis. ``local=True``: ``ctx`` is this rank's
        subject's alone, without the batch axis (each rank encodes its
        own image)."""
        ctx_b = ctx if local else _take(ctx, self.mesh.index(DATA_AXIS))
        hr, lr = eval_grid_octree(
            lambda pts: self.eval_fn(pts, ctx_b), self.R, self.mat,
            self.threshold, init_resolution=self.init_resolution,
            num_samples=self.num_samples, device=self.mesh.device)
        if not gather:
            return hr, lr
        comm = self.mesh.comm(DATA_AXIS)
        return (torch.stack(comm.all_gather(hr)),
                torch.stack(comm.all_gather(lr)))

    def reconstruct(self, ctx: Any, level: float = 0.5, local: bool = False
                    ) -> Optional[List[Tuple[np.ndarray, np.ndarray,
                                             np.ndarray, np.ndarray]]]:
        """Every subject's (verts_hr, faces_hr, verts_lr, faces_lr) in
        world coordinates on the ``data`` axis' rank 0, None on the other
        ranks. Each rank meshes its own subject with
        ``recon.marching.extract_isosurface``'s default (the host
        library's marching tetrahedra: what the JAX package's 'auto'
        resolves to, ``surs_tpu/recon/marching.py:13-15``). ``local`` as
        in :meth:`evaluate`."""
        sdf_hr, sdf_lr = self.evaluate(ctx, local=local)
        mine = []
        for vol in (sdf_hr, sdf_lr):
            verts, faces = extract_isosurface(vol, level)
            verts = verts @ self.mat[:3, :3].T + self.mat[:3, 3]
            mine += [verts.astype(np.float32), faces]
        comm = self.mesh.comm(DATA_AXIS)
        dev = self.mesh.device
        parts = [comm.gather_v(torch.from_numpy(np.ascontiguousarray(a))
                               .to(dev)) for a in mine]
        if parts[0] is None:
            return None
        return [tuple(p[b].cpu().numpy() for p in parts)
                for b in range(self.n_data)]
