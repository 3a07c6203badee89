"""Classic marching cubes in torch, on whatever device the field lives
on (counterpart of ``marching_cubes_classic``,
``surs_tpu/recon/mc_tables.py:136-199``, over the port's own copy of the
constructed case table).

Output contract: (verts [V, 3] float32 grid coordinates, faces [F, 3]
int64), vertices welded on global edge keys, faces in table order. The
result equals the numpy reference exactly: the welding keeps, for every
edge key, the LAST triangle corner that names it, as numpy's repeated
-index assignment does, through ``scatter_reduce(amax)`` over the corner
positions (``index_put_`` with repeated indices is nondeterministic on
CUDA).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .mc_tables import _CORNER_OFFSETS, MC_CASE_TRIS, MC_EDGES, MC_MAX_TRIS


def marching_cubes(volume: torch.Tensor, level: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Isosurface ``volume == level`` of an [X, Y, Z] field; a point is
    inside where its value > level."""
    dev = volume.device
    vol = volume.float().contiguous()
    X, Y, Z = vol.shape
    offs = torch.as_tensor(_CORNER_OFFSETS, device=dev)
    cmax = vol[:-1, :-1, :-1]
    cmin = cmax
    for dx, dy, dz in _CORNER_OFFSETS[1:].tolist():
        blk = vol[dx:X - 1 + dx, dy:Y - 1 + dy, dz:Z - 1 + dz]
        cmax = torch.maximum(cmax, blk)
        cmin = torch.minimum(cmin, blk)
    active = torch.nonzero((cmin <= level) & (cmax > level))     # [M, 3]
    if active.shape[0] == 0:
        return (torch.zeros((0, 3), dtype=torch.float32, device=dev),
                torch.zeros((0, 3), dtype=torch.int64, device=dev))

    corner = active[:, None, :] + offs[None, :, :]               # [M, 8, 3]
    gid = (corner[..., 0] * Y + corner[..., 1]) * Z + corner[..., 2]
    flat = vol.reshape(-1)
    inside = flat[gid] > level
    case = (inside.long() << torch.arange(8, device=dev)).sum(dim=1)

    case_tris = torch.as_tensor(MC_CASE_TRIS, device=dev)       # [256, 5, 3]
    edges = torch.as_tensor(MC_EDGES, device=dev)               # [12, 2]
    keys, ends = [], []
    n_vox = X * Y * Z
    for slot in range(MC_MAX_TRIS):
        tris = case_tris[case, slot]                             # [M, 3]
        has = tris[:, 0] >= 0
        if not bool(has.any()):
            continue
        tris_h = tris[has]
        g = gid[has]
        ga = torch.gather(g, 1, edges[tris_h][..., 0])
        gb = torch.gather(g, 1, edges[tris_h][..., 1])
        keys.append(torch.minimum(ga, gb) * n_vox + torch.maximum(ga, gb))
        ends.append(torch.stack([ga, gb], dim=-1))
    keys = torch.cat(keys).reshape(-1)
    ends = torch.cat(ends).reshape(-1, 2)
    uniq, inv = torch.unique(keys, sorted=True, return_inverse=True)
    faces = inv.reshape(-1, 3)
    last = torch.zeros(uniq.shape[0], dtype=torch.int64, device=dev)
    last = last.scatter_reduce(0, inv, torch.arange(inv.shape[0], device=dev),
                               reduce="amax", include_self=False)
    rep = ends[last]

    va = flat[rep[:, 0]].double()
    vb = flat[rep[:, 1]].double()
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
    return verts.float(), faces[ok]
