"""Judging a served OBJ pair against the plain fields.

A served mesh is marching cubes of an occupancy field at level 0.5 on
the R^3 grid: each vertex lies on one grid edge (two of its grid
coordinates integral) at the linear crossing of the field's values at
the edge's ends, written with 4 decimals in world units. For a vertex
the reference reads its own field at the edge's ends, and the vertex's
**gap** is how far 0.5 lies outside the values that the reference's
linear field takes over the vertex's place on the edge, widened by the
writer's rounding: 0 where the reference puts the crossing within the
rounding, else the distance in occupancy. A program whose field is off
by e everywhere has gaps of at most e.

The check reads, for each mesh:

* a sample of vertices drawn from the seed (their gaps);
* every edge of a sample of grid lines along each axis: each vertex
  the program put there (its gap), and each crossing of the reference's
  field that the program left without a vertex (its gap: the nearer
  end's distance from 0.5), with the share of such mismatches;
* a sample of faces: indices in range and the three corners in one
  grid cell;
* vertices on no grid edge, which are malformed.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .octree import crossings

# grid nodes [N, 3] int64 -> field values [N] float64 numpy
FieldAt = Callable[[np.ndarray], np.ndarray]


def parse_fixed(text: bytes, per_line: int) -> np.ndarray:
    """Lines of ``per_line`` numbers, each after one space and written
    with an optional sign, integer digits, a point and 4 decimals (the
    writer's format) -> [lines, per_line] float64. Raises ValueError on
    any other text."""
    a = np.frombuffer(text, np.uint8)
    sp = np.flatnonzero(a == 32)
    dot = np.flatnonzero(a == 46)
    lines = int(np.count_nonzero(a == 10))
    if len(sp) != len(dot) or len(sp) != per_line * lines:
        raise ValueError("not the writer's vertex format")
    neg = a[np.minimum(sp + 1, len(a) - 1)] == 45
    start = sp + 1 + neg
    width = dot - start
    if len(dot) and (width.min() < 1 or width.max() > 12
                     or dot.max() + 4 >= len(a)):
        raise ValueError("not the writer's vertex format")
    frac = np.zeros(len(dot), np.int64)
    for j in range(1, 5):
        d = a[dot + j].astype(np.int64) - 48
        if len(d) and (d.min() < 0 or d.max() > 9):
            raise ValueError("not the writer's vertex format")
        frac = frac * 10 + d
    whole = np.zeros(len(dot), np.int64)
    for j in range(int(width.max()) if len(dot) else 0):
        on = j < width
        d = a[np.where(on, start + j, 0)].astype(np.int64) - 48
        if len(d) and ((d[on] < 0) | (d[on] > 9)).any():
            raise ValueError("not the writer's vertex format")
        whole = np.where(on, whole * 10 + d, whole)
    val = whole + frac / 1e4
    return np.where(neg, -val, val).reshape(-1, per_line)


def parse_obj(buf: bytes, face_sample: int, rng: np.random.Generator
              ) -> Tuple[np.ndarray, np.ndarray, int]:
    """OBJ text -> (vertices [V, 3] float64, a sample of faces [F', 3]
    0-based int64, the number of faces)."""
    cut = buf.find(b"\nf ")
    vsec = buf if cut < 0 else buf[:cut + 1]
    fsec = b"" if cut < 0 else buf[cut + 1:]
    verts = parse_fixed(vsec, 3) if vsec else np.zeros((0, 3))
    if not fsec:
        return verts, np.zeros((0, 3), np.int64), 0
    ends = np.flatnonzero(np.frombuffer(fsec, np.uint8) == 10)
    n_faces = len(ends)
    pick = np.sort(rng.choice(n_faces, min(face_sample, n_faces),
                              replace=False))
    starts = np.concatenate([[0], ends[:-1] + 1])[pick]
    faces = [[int(t) - 1 for t in fsec[s:e].split()[1:4]]
             for s, e in zip(starts, ends[pick])]
    return verts, np.asarray(faces, np.int64).reshape(-1, 3), n_faces


def round_like_writer(verts_world: np.ndarray) -> np.ndarray:
    """World coordinates as the 4-decimal OBJ text holds them."""
    r = np.floor(np.abs(verts_world) * 1e4 + 0.5) / 1e4
    return np.where(verts_world < 0, -r, r)


class Grid:
    """The R^3 grid over [b_min, b_max): world <-> grid coordinates, and
    the slack of a written coordinate in grid units."""

    def __init__(self, R: int, b_min, b_max):
        self.R = R
        self.b_min = np.asarray(b_min, np.float64)
        self.h = (np.asarray(b_max, np.float64) - self.b_min) / R
        # the writer's rounding (half of 1e-4) and float32 vertices
        self.slack = float(np.max(0.5e-4 / self.h) * 1.001 + 1e-4)

    def to_grid(self, world: np.ndarray) -> np.ndarray:
        return (world - self.b_min) / self.h

    def to_world(self, g: np.ndarray) -> np.ndarray:
        return g * self.h + self.b_min


def edges_of(g: np.ndarray, grid: Grid):
    """The grid edges that vertices at grid coordinates g [V, 3] may lie
    on: per axis, (edge start node [V, 3] int64, place on the edge t
    [V], possible [V] bool: the other two coordinates integral within
    the writer's rounding)."""
    near = np.rint(g)
    close = np.abs(g - near) <= grid.slack
    inside = (g >= -grid.slack).all(1) & (g <= grid.R - 1 + grid.slack).all(1)
    base = np.clip(near.astype(np.int64), 0, grid.R - 1)
    out = []
    for axis in range(3):
        others = [a for a in range(3) if a != axis]
        ok = close[:, others[0]] & close[:, others[1]] & inside
        a = np.clip(np.floor(g[:, axis]), 0, grid.R - 2).astype(np.int64)
        out.append((base, axis, a, g[:, axis] - a, ok))
    return out


def vertex_gaps(fa: np.ndarray, fb: np.ndarray, t: np.ndarray,
                slack: float, level: float = 0.5) -> np.ndarray:
    """How far ``level`` lies outside fa + s (fb - fa) for s in
    [t - slack, t + slack] clipped to [0, 1]."""
    s0 = np.clip(t - slack, 0.0, 1.0)
    s1 = np.clip(t + slack, 0.0, 1.0)
    h0 = fa + s0 * (fb - fa)
    h1 = fa + s1 * (fb - fa)
    lo = np.minimum(h0, h1)
    hi = np.maximum(h0, h1)
    return np.maximum(0.0, np.maximum(lo - level, level - hi))


def check_mesh(verts_world: np.ndarray, faces: Optional[np.ndarray],
               field_at: FieldAt, lines: Sequence, grid: Grid,
               n_vertices: int, rng: np.random.Generator,
               level: float = 0.5) -> Dict[str, np.ndarray]:
    """Gaps of one served mesh: ``verts_world`` [V, 3] as written,
    ``faces`` a sample [F', 3] (None: not checked), ``field_at`` the
    reference's field at grid nodes, ``lines`` [(axis, other coordinates
    [C, 2] of C sampled grid lines along the axis, the reference's field
    along them [C, R])]. Returns {"vertex": gaps, "column": gaps,
    "malformed": count, ...}."""
    R = grid.R
    g = grid.to_grid(verts_world)
    edges = edges_of(g, grid)
    possible = edges[0][4] | edges[1][4] | edges[2][4]
    malformed = int((~possible).sum())

    def gaps_of(idx: np.ndarray) -> np.ndarray:
        # a vertex near a grid node may lie on any edge its rounding
        # allows: its gap is the least over those edges
        out = np.full(len(idx), np.inf)
        for base, ax, a, t, ok in edges:
            na = base[idx].copy()
            na[:, ax] = a[idx]
            nb = na.copy()
            nb[:, ax] += 1
            vals = field_at(np.concatenate([na, nb]))
            gk = vertex_gaps(vals[:len(idx)], vals[len(idx):], t[idx],
                             grid.slack, level)
            out = np.where(ok[idx], np.minimum(out, gk), out)
        return out

    pick = rng.choice(len(g), min(n_vertices, len(g)), replace=False) \
        if len(g) else np.zeros(0, np.int64)
    v_gap = gaps_of(pick[possible[pick]])
    line_gaps = []
    n_edges = n_crossed = n_missed = n_extra = 0
    for axis, cols, field in lines:
        gl, crossed, missed, extra = _line_check(
            g, edges[axis], axis, cols, field, grid, gaps_of, level)
        line_gaps.append(gl)
        n_edges += len(gl)
        n_crossed += crossed
        n_missed += missed
        n_extra += extra
    if faces is not None and len(faces):
        bad = (faces < 0) | (faces >= len(g))
        ok_rows = ~bad.any(1)
        fg = g[np.clip(faces[ok_rows], 0, max(len(g) - 1, 0))]
        span = (fg.max(1) - fg.min(1)).max(1)
        malformed += int(bad.any(1).sum()) + int(
            (span > 1.0 + 2 * grid.slack).sum())
    return {"vertex": v_gap,
            "column": np.concatenate(line_gaps) if line_gaps
            else np.zeros(0),
            "malformed": malformed, "n_vertices": len(g),
            "n_column_edges": n_edges, "column_crossings": n_crossed,
            "column_missed": n_missed, "column_extra": n_extra}


def _line_check(g, edge, axis, cols, field, grid, gaps_of, level):
    """The edges along ``axis`` of the sampled lines: the gap of each
    vertex the program put there and of each reference crossing left
    without one; returns (gaps, crossings, crossings missed, vertices
    where the reference does not cross)."""
    R = grid.R
    base, _, _, _, ok = edge
    others = [a for a in range(3) if a != axis]
    col_key = cols[:, 0].astype(np.int64) * R + cols[:, 1]
    order = np.argsort(col_key)
    on = np.flatnonzero(ok)
    key = base[on, others[0]] * R + base[on, others[1]]
    pos = np.clip(np.searchsorted(col_key[order], key), 0,
                  len(col_key) - 1)
    match = col_key[order][pos] == key
    hit = on[match]
    ci = order[pos[match]]
    served_gap = gaps_of(hit)
    cf = field.double().cpu().numpy()
    idx, _ = crossings(field, level)
    rc = idx[:, 0].cpu().numpy()
    rk = idx[:, 1].cpu().numpy()
    # a vertex within the rounding of a node stands for either edge
    ga = g[hit, axis]
    lo = np.clip(np.floor(ga - grid.slack), 0, R - 2).astype(np.int64)
    hi = np.clip(np.floor(ga + grid.slack), 0, R - 2).astype(np.int64)
    served = set(zip(ci.tolist(), lo.tolist())) | set(
        zip(ci.tolist(), hi.tolist()))
    missing = np.array([(c, k) not in served for c, k in zip(rc, rk)],
                       dtype=bool)
    fa = cf[rc[missing], rk[missing]]
    fb = cf[rc[missing], rk[missing] + 1]
    miss_gap = np.minimum(np.abs(fa - level), np.abs(fb - level))
    crossed = set(zip(rc.tolist(), rk.tolist()))
    extra = sum(1 for c, k0, k1 in zip(ci.tolist(), lo.tolist(),
                                       hi.tolist())
                if (c, k0) not in crossed and (c, k1) not in crossed)
    return (np.concatenate([served_gap, miss_gap]), len(rc),
            int(missing.sum()), extra)


def crossings_3d(field: torch.Tensor, level: float = 0.5) -> np.ndarray:
    """Every marching-cubes vertex of a whole [R, R, R] field, grid
    coordinates [V, 3] float64 (the control's mesh)."""
    out = []
    for ax in range(3):
        idx, t = crossings(field.movedim(ax, -1), level)
        c = idx.double()
        c[:, -1] += t
        out.append(c[:, [*range(ax), 2, *range(ax, 2)]] if ax < 2 else c)
    return torch.cat(out).cpu().numpy()
