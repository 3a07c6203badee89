"""Slab-sharded isosurface extraction over a mesh axis (counterpart of
``surs_tpu/parallel/sharded_mc.py``).

The volume is split into x-slabs, one a rank of the axis. Each rank
takes the first plane of its +x neighbour as its halo (one all-gather of
first planes over the axis: the counterpart of the JAX ``lax.ppermute``),
meshes its slab and halo with the port's march (``recon/marching.py``
``march_slab``) and the axis' rank 0 gathers every rank's edge keys,
vertices and faces and merges them by global edge key.

Ownership, as in the JAX package (:70-92):

  * a CELL belongs to the rank whose slab holds its base plane, so the
    ranks' active cells partition the field's;
  * the LAST rank has no neighbour: its halo is a copy of its own last
    plane, and it owns one plane of cells fewer, so no phantom crossing
    forms against the copy;
  * an edge that two slabs both emit (on the plane they share) gets the
    same key and the same vertex in both: every rank interpolates a
    vertex from its edge's (lower id, higher id) ends in float64, so the
    merge is an integer dedup, never an epsilon match.

The JAX halo is 4 planes so that its packed 4^3 word stencils keep their
shape; the port's march needs one plane, and takes one. The slab-shape
and ``max_cells_shard`` checks are the JAX package's. Its third check,
at most 2^21 / slots crossing points a slab, guards the JAX package's
packed faces (21-bit vertex indices in one word); the port's faces are
int64 and its slabs weld by int64 edge key, so it takes such slabs and
returns the mesh where the JAX package raises. The merged mesh's
vertices come out in global edge-key order, the single-device march's
order; its faces in rank order, each rank's in the march's emission
order.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..recon.marching import (CUBE_GROUPS, CapacityError,
                              count_active_cells, march_slab)
from ..recon.tetra import TET_GROUPS
from .mesh import POINT_AXIS, Mesh, make_mesh

MIN_SLAB = 4          # the JAX package's HALO: X/n >= 4, (X/n) % 4 == 0

_GROUPS = {"cubes": CUBE_GROUPS, "tets": TET_GROUPS}


def _slab_mesh(mesh: Optional[Mesh], axis: Optional[str]
               ) -> Tuple[Mesh, str]:
    """The caller's mesh, or every rank of the process group on
    ``points`` (this process alone without one), as the JAX package
    takes every device (``surs_tpu/parallel/sharded_mc.py:57-62``)."""
    if mesh is not None:
        return mesh, (axis or POINT_AXIS)
    if not dist.is_initialized():
        return make_mesh(), POINT_AXIS
    return make_mesh(n_data=1, n_points=dist.get_world_size()), POINT_AXIS


def _with_halo(local: torch.Tensor, comm) -> torch.Tensor:
    """[Xs, Y, Z] slab -> [Xs + 1, Y, Z]: the +x neighbour's first plane,
    or on the last rank its own last plane."""
    firsts = comm.all_gather(local[:1].contiguous())
    s = comm.rank
    halo = firsts[s + 1] if s < comm.size - 1 else local[-1:]
    return torch.cat([local, halo])


def extract_isosurface_sharded_begin(volume, level: float = 0.5,
                                     mesh: Optional[Mesh] = None,
                                     axis: Optional[str] = None,
                                     algorithm: str = "cubes",
                                     cell_chunk: int = 1 << 16,
                                     max_cells_shard: int = 1 << 21,
                                     max_tris_shard: Optional[int] = None,
                                     defer_sync: bool = False,
                                     local: bool = False):
    """Begin the sharded extraction of ``volume`` over ``mesh[axis]``
    (default: every rank of the process group, or this one alone) and
    return it staged as the JAX package stages it:

      * here the halo is exchanged and the slab's active cells are
        counted on the device, with no host sync;
        with ``defer_sync=True`` the caller gets ``resolve`` back, so a
        second extraction (the LR field) begins before either syncs;
      * ``resolve()`` gathers every rank's active-cell count (every rank
        raises the same error, the JAX package's, on a slab over
        ``max_cells_shard``), meshes the slab, and returns ``finish``;
      * ``finish()`` gathers the slabs' meshes on the axis' rank 0 and
        merges them by global edge key: (verts [V, 3] float32 grid
        coordinates, faces [F, 3] int64) numpy arrays there, None on the
        other ranks. A rank over ``max_tris_shard`` triangles makes
        every rank raise ``CapacityError``.

    ``defer_sync=False`` returns ``resolve()()``. ``volume`` is the whole
    [X, Y, Z] field (each rank takes its slab), or with ``local=True``
    this rank's x-slab [X/n, Y, Z], as
    ``recon.evaluator.eval_grid_dense_cols_sharded`` returns it.
    Requires X % n == 0, (X/n) % 4 == 0, X/n >= 4, Y % 4 == 0 and
    Z % 32 == 0, as the JAX package does.
    """
    mesh, axis = _slab_mesh(mesh, axis)
    comm = mesh.comm(axis)
    n, s = comm.size, comm.rank
    if algorithm not in _GROUPS:
        raise ValueError(f"unknown mc algorithm {algorithm!r}")
    vol = torch.as_tensor(volume)
    if vol.device.type == "cpu" and mesh.device.type != "cpu":
        vol = vol.to(mesh.device)
    vol = vol.float()
    X = vol.shape[0] * n if local else vol.shape[0]
    Y, Z = vol.shape[1:]
    shape = (X, Y, Z)
    if X % n or (X // n) % 4 or X // n < MIN_SLAB or Y % 4 or Z % 32:
        raise ValueError(
            f"sharded extraction needs X % {n} == 0, (X/n) % 4 == 0, "
            f"X/n >= {MIN_SLAB}, Y % 4 == 0, Z % 32 == 0; got {shape}")
    Xs = X // n
    own = vol if local else vol[s * Xs:(s + 1) * Xs]
    slab = _with_halo(own, comm)
    x_act = Xs - 1 if s == n - 1 else Xs
    cells = count_active_cells(slab, level, x_act_limit=x_act).reshape(1)

    def resolve() -> Callable:
        nc = int(torch.cat(comm.all_gather(cells)).max())
        if nc > max_cells_shard:
            raise ValueError(
                f"sharded extraction: {nc} active cells in one "
                f"slab > max_cells_shard {max_cells_shard}")
        keys, verts, faces = march_slab(
            slab, level, _GROUPS[algorithm], "sharded extraction",
            x_offset=s * Xs, global_x=X, x_act_limit=x_act,
            cell_chunk=cell_chunk)

        def finish():
            tris = torch.cat(comm.all_gather(torch.tensor(
                [faces.shape[0]], device=faces.device))).cpu()
            if max_tris_shard is not None and tris.max() > max_tris_shard:
                raise CapacityError(
                    f"sharded extraction capacity overflow: tris "
                    f"{int(tris.max())}/{max_tris_shard}")
            parts = [comm.gather_v(t) for t in (keys, verts, faces)]
            if parts[0] is None:
                return None
            return merge_slabs(*parts)

        return finish

    if defer_sync:
        return resolve
    return resolve()()


def merge_slabs(keys, verts, faces) -> Tuple[np.ndarray, np.ndarray]:
    """The slabs' (keys [V_i], verts [V_i, 3], faces [F_i, 3]) lists, in
    rank order -> one mesh welded by key: (verts [V, 3] float32, faces
    [F, 3] int64) numpy arrays, the vertices in key order."""
    offs = np.cumsum([0] + [k.shape[0] for k in keys[:-1]])
    key_all = torch.cat(keys)
    face_all = torch.cat([f + int(o) for f, o in zip(faces, offs)])
    uniq, inv = torch.unique(key_all, sorted=True, return_inverse=True)
    out = torch.empty((uniq.shape[0], 3), dtype=torch.float32,
                      device=key_all.device)
    # the copies of a key hold the same vertex: any one may land
    out[inv] = torch.cat(verts)
    return out.cpu().numpy(), inv[face_all].cpu().numpy()


def extract_isosurface_sharded(volume, level: float = 0.5,
                               **kw) -> Optional[Tuple[np.ndarray,
                                                       np.ndarray]]:
    """One-call sharded extraction (see
    :func:`extract_isosurface_sharded_begin` for the staging, the slab
    shapes and what the ranks return)."""
    return extract_isosurface_sharded_begin(volume, level, **kw)


def gather_field(slab: torch.Tensor, mesh: Mesh,
                 axis: str = POINT_AXIS) -> torch.Tensor:
    """The whole [X, Y, Z] field on every rank of the axis, from each
    rank's x-slab (``eval_grid_dense_cols_sharded``'s output)."""
    return torch.cat(mesh.comm(axis).all_gather(slab.contiguous()))
