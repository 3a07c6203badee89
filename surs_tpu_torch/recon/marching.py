"""Isosurface extraction in torch, on whatever device the field lives on:
classic marching cubes (counterpart of ``marching_cubes_classic``,
``surs_tpu/recon/mc_tables.py:136-199``, over the port's own copy of the
constructed case table) and, through the same cell emission, marching
tetrahedra (``recon/tetra.py``); and the extraction entry point
``extract_isosurface`` (``surs_tpu/recon/marching.py``), whose default is
the host library's marching tetrahedra.

Output contract of both torch extractors: (verts [V, 3] float32 grid
coordinates, faces [F, 3] int64), vertices welded on global edge keys in
sorted key order, faces in (group, slot, cell) emission order. The result
equals the numpy reference exactly: the welding keeps, for every edge key,
the LAST triangle corner that names it, as numpy's repeated-index
assignment does, through ``scatter_reduce(amax)`` over the corner
positions (``index_put_`` with repeated indices is nondeterministic on
CUDA).

Torch has no static shapes, so the capacities (``max_cells``,
``max_tris``, ``max_verts``, ``max_pts``) are off by default; a capacity a
caller sets raises :class:`CapacityError` when the field exceeds it, as
the JAX device extractor does (``surs_tpu/recon/tetra_device.py:915``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.profiling import host_wait
from . import native
from .mc_tables import _CORNER_OFFSETS, MC_CASE_TRIS, MC_EDGES


class CapacityError(ValueError):
    """A field needs more cells, points, triangles or vertices than the
    capacity the caller set."""


def _case_ends(corners: Sequence[int], case_tris: np.ndarray,
               edges: np.ndarray) -> np.ndarray:
    """A group's table as cube-corner pairs: [2^k, slots, 3, 2], -1 where
    a slot holds no triangle. ``case_tris`` [2^k, slots, 3] holds edge
    ids into ``edges`` (pairs of the group's own corners)."""
    corners = np.asarray(corners, np.int64)
    ends = corners[edges[np.maximum(case_tris, 0)]]
    ends[case_tris < 0] = -1
    return ends


# marching cubes: one group of the cube's 8 corners
CUBE_GROUPS = [(list(range(8)), _case_ends(range(8), MC_CASE_TRIS,
                                           MC_EDGES))]


def _check(name: str, what: str, n: int, cap: Optional[int]) -> None:
    if cap is not None and n > cap:
        raise CapacityError(f"{name} capacity exceeded: {what} {n}/{cap}")


def march(volume: torch.Tensor, level: float, groups, name: str,
          cell_chunk: Optional[int] = None, max_cells: Optional[int] = None,
          max_tris: Optional[int] = None, max_verts: Optional[int] = None,
          max_pts: Optional[int] = None, stats: Optional[Dict] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cell emission and welding shared by marching cubes and
    marching tetrahedra. ``groups`` lists (cube corners [k], case table
    [2^k, slots, 3, 2] of cube-corner pairs): a cell's case in a group has
    bit i set where its corner ``corners[i]`` is inside (value > level),
    and each slot of the case emits one triangle whose vertices lie on
    the three corner pairs. Triangles come out group by group, slot by
    slot, cell by cell. ``cell_chunk`` bounds the cells emitted at once
    (the working set on the card) without changing the result. ``stats``
    counts the host's waits on the card (``utils.profiling.host_wait``):
    each compaction, size read and table copy."""
    _, verts, faces = _march(volume, level, groups, name, cell_chunk,
                             max_cells, max_tris, max_verts, max_pts,
                             stats=stats)
    return verts, faces


def march_slab(slab: torch.Tensor, level: float, groups, name: str,
               x_offset: int, global_x: int, x_act_limit: int,
               cell_chunk: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`march` over one x-slab of a [global_x, Y, Z] field, the
    slab ownership of ``_march_core(x_act_limit=)``
    (``surs_tpu/recon/tetra_device.py:629``): ``slab`` holds the planes
    ``x_offset ...`` of the field (the slab and its halo), and only the
    cells whose base plane is below ``x_act_limit`` (slab-local) emit.
    Returns (edge keys [V] int64, verts [V, 3] float32, faces [F, 3]
    int64): the keys and the vertices in GLOBAL coordinates, each vertex
    interpolated from its edge's (lower id, higher id) ends, so every
    slab that emits an edge computes the same vertex and slabs merge by
    key (``parallel/sharded_mc.py``).

    The crossing-point and edge limits of ``_march_core`` have no
    counterpart here: this march welds only the edges of the triangles
    that owned cells emit, so a halo plane's points enter only through
    an owned cell's edges and the halo's own edges never do."""
    return _march(slab, level, groups, name, cell_chunk, None, None, None,
                  None, x_offset=x_offset, global_x=global_x,
                  x_act_limit=x_act_limit)


def count_active_cells(slab: torch.Tensor, level: float,
                       x_act_limit: int) -> torch.Tensor:
    """Active cells of a slab with base plane < ``x_act_limit``, a 0-d
    device tensor, no sync (``_count_cells``,
    ``surs_tpu/recon/tetra_device.py:840``)."""
    inside = slab > level
    X, Y, Z = inside.shape
    cmax = torch.zeros((X - 1, Y - 1, Z - 1), dtype=torch.bool,
                       device=slab.device)
    cmin = torch.ones_like(cmax)
    for dx, dy, dz in _CORNER_OFFSETS.tolist():
        blk = inside[dx:X - 1 + dx, dy:Y - 1 + dy, dz:Z - 1 + dz]
        cmax |= blk
        cmin &= blk
    return (cmax & ~cmin)[:x_act_limit].sum()


def _march(volume: torch.Tensor, level: float, groups, name: str,
           cell_chunk: Optional[int], max_cells: Optional[int],
           max_tris: Optional[int], max_verts: Optional[int],
           max_pts: Optional[int], x_offset: int = 0,
           global_x: Optional[int] = None,
           x_act_limit: Optional[int] = None,
           stats: Optional[Dict] = None):
    """-> (edge keys, verts, faces); ``global_x`` set: the slab mode of
    :func:`march_slab`."""
    dev = volume.device
    vol = volume.float().contiguous()
    X, Y, Z = vol.shape
    slab = global_x is not None
    empty = (torch.zeros((0,), dtype=torch.int64, device=dev),
             torch.zeros((0, 3), dtype=torch.float32, device=dev),
             torch.zeros((0, 3), dtype=torch.int64, device=dev))
    cmax = vol[:-1, :-1, :-1]
    cmin = cmax
    for dx, dy, dz in _CORNER_OFFSETS[1:].tolist():
        blk = vol[dx:X - 1 + dx, dy:Y - 1 + dy, dz:Z - 1 + dz]
        cmax = torch.maximum(cmax, blk)
        cmin = torch.minimum(cmin, blk)
    cells = (cmin <= level) & (cmax > level)
    if x_act_limit is not None:
        cells = cells[:x_act_limit]
    with host_wait(stats):
        active = torch.nonzero(cells)                            # [M, 3]
    del cmin, cmax, cells
    n_cells = active.shape[0]
    _check(name, "cells", n_cells, max_cells)
    if n_cells == 0:
        return empty

    with host_wait(stats):
        offs = torch.as_tensor(_CORNER_OFFSETS, device=dev)
    flat = vol.reshape(-1)
    tables = []
    for c, t in groups:
        with host_wait(stats):
            corners = torch.as_tensor(np.asarray(c), device=dev)
        with host_wait(stats):
            tables.append((corners, torch.as_tensor(t, device=dev)))
    n_slots = [t.shape[1] for _, t in tables]
    # keys / ends per (group, slot), each a list over the cell chunks
    keys = [[[] for _ in range(s)] for s in n_slots]
    ends = [[[] for _ in range(s)] for s in n_slots]
    base = x_offset * Y * Z          # global id of the volume's first point
    n_vox = (global_x if slab else X) * Y * Z
    step = n_cells if cell_chunk is None else cell_chunk
    for lo in range(0, n_cells, step):
        corner = active[lo:lo + step, None, :] + offs[None, :, :]
        gid = (corner[..., 0] * Y + corner[..., 1]) * Z + corner[..., 2]
        inside = flat[gid] > level                               # [m, 8]
        gid = gid + base
        for g, (corners, table) in enumerate(tables):
            bits = torch.arange(corners.shape[0], device=dev)
            case = (inside[:, corners].long() << bits).sum(dim=1)
            for slot in range(n_slots[g]):
                tri = table[case, slot]                          # [m, 3, 2]
                has = tri[:, 0, 0] >= 0
                with host_wait(stats):
                    tri = tri[has]
                with host_wait(stats):
                    g_has = gid[has]
                ga = torch.gather(g_has, 1, tri[..., 0])
                gb = torch.gather(g_has, 1, tri[..., 1])
                keys[g][slot].append(torch.minimum(ga, gb) * n_vox
                                     + torch.maximum(ga, gb))
                if not slab:
                    ends[g][slot].append(torch.stack([ga, gb], dim=-1))
    keys = torch.cat([k for per in keys for chunks in per for k in chunks])
    _check(name, "tris", keys.shape[0], max_tris)
    if keys.shape[0] == 0:
        return empty
    keys = keys.reshape(-1)
    with host_wait(stats):
        uniq, inv = torch.unique(keys, sorted=True, return_inverse=True)
    _check(name, "verts", uniq.shape[0], max_verts)
    if max_pts is not None:
        # an edge runs from its componentwise-min lattice point, the
        # smaller id: the crossing points are the distinct low ends
        with host_wait(stats):
            n_pts = torch.unique(uniq // n_vox).shape[0]
        _check(name, "pts", n_pts, max_pts)
    faces = inv.reshape(-1, 3)
    if slab:
        # every slab orients an edge the same way: (lower, higher) id
        rep = torch.stack([uniq // n_vox, uniq % n_vox], dim=-1)
    else:
        ends = torch.cat([e for per in ends for chunks in per
                          for e in chunks]).reshape(-1, 2)
        last = torch.zeros(uniq.shape[0], dtype=torch.int64, device=dev)
        last = last.scatter_reduce(0, inv,
                                   torch.arange(inv.shape[0], device=dev),
                                   reduce="amax", include_self=False)
        rep = ends[last]

    va = flat[rep[:, 0] - base].double()
    vb = flat[rep[:, 1] - base].double()
    denom = vb - va
    denom = torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12),
                        denom)
    t = ((level - va) / denom).clamp(0.0, 1.0)

    def unflat(g):
        return torch.stack([g // (Y * Z), (g // Z) % Y, g % Z], dim=-1)

    pa = unflat(rep[:, 0]).double()
    pb = unflat(rep[:, 1]).double()
    verts = pa + t[:, None] * (pb - pa)
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    with host_wait(stats):
        faces = faces[ok]
    return uniq, verts.float(), faces


def marching_cubes(volume: torch.Tensor, level: float, **caps
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Isosurface ``volume == level`` of an [X, Y, Z] field; a point is
    inside where its value > level. ``caps``: ``cell_chunk``, the
    capacities of :func:`march` and its ``stats``."""
    return march(volume, level, CUBE_GROUPS, "marching_cubes", **caps)


def extract_isosurface(volume, level: float = 0.5, backend: str = "native"
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """(verts [V, 3] float32 grid coordinates, faces [F, 3] int64) numpy
    arrays of ``volume == level`` by marching tetrahedra
    (``surs_tpu/recon/marching.py:13-28``). ``backend``: 'native' (the
    host library, ``recon/native.py``; the field is copied to the host),
    'torch' (``recon/tetra.py`` on the field's device) or 'auto', which is
    'native': the port always builds its host library, and a missing
    compiler raises rather than switching to the torch version."""
    if backend in ("native", "auto"):
        if isinstance(volume, torch.Tensor):
            volume = volume.detach().float().cpu().numpy()
        return native.marching_tetrahedra(volume, level)
    if backend == "torch":
        from .tetra import marching_tetrahedra     # tetra imports march
        verts, faces = marching_tetrahedra(torch.as_tensor(volume), level)
        return verts.cpu().numpy(), faces.cpu().numpy()
    raise ValueError(f"unknown extraction backend {backend!r}")
