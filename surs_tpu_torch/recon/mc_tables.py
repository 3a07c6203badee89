"""Constructed classic marching-cubes case table (the port's own copy
of ``surs_tpu/recon/mc_tables.py``).

The 256-case triangulation is derived at import time by the textbook
construction: each cube face pairs its crossing edges into contour
segments (the ambiguous 4-crossing face connects the edges around its
positive corners, a rule mirror-symmetric between neighbouring cells, so
the surface is crack-free); the segments close into loops, which are
fan-triangulated and oriented so that normals point from the inside
(value > level) to the outside.
"""

from __future__ import annotations

import numpy as np

_CORNER_OFFSETS = np.array([
    [0, 0, 0],  # 0
    [1, 0, 0],  # 1
    [1, 1, 0],  # 2
    [0, 1, 0],  # 3
    [0, 0, 1],  # 4
    [1, 0, 1],  # 5
    [1, 1, 1],  # 6
    [0, 1, 1],  # 7
], dtype=np.int64)

# 12 axis edges as (corner_a, corner_b); a is the lexicographically
# smaller corner position.
MC_EDGES = np.array([
    (0, 1), (3, 2), (4, 5), (7, 6),     # x-edges
    (0, 3), (1, 2), (4, 7), (5, 6),     # y-edges
    (0, 4), (1, 5), (2, 6), (3, 7),     # z-edges
], np.int64)

# faces as cyclic corner quads
_FACES = [
    (0, 1, 2, 3),   # z = 0
    (4, 5, 6, 7),   # z = 1
    (0, 1, 5, 4),   # y = 0
    (3, 2, 6, 7),   # y = 1
    (0, 3, 7, 4),   # x = 0
    (1, 2, 6, 5),   # x = 1
]

_EDGE_ID = {}
for _i, (_a, _b) in enumerate(MC_EDGES):
    _EDGE_ID[(int(_a), int(_b))] = _i
    _EDGE_ID[(int(_b), int(_a))] = _i

MC_MAX_TRIS = 5


def _build_tables():
    """-> (tri_edges [256, MC_MAX_TRIS, 3] edge ids or -1)."""
    corner_pos = _CORNER_OFFSETS.astype(np.float64)
    edge_mid = corner_pos[MC_EDGES].mean(axis=1)           # [12, 3]
    tris_out = -np.ones((256, MC_MAX_TRIS, 3), np.int64)

    for case in range(256):
        inside = [(case >> c) & 1 == 1 for c in range(8)]
        crossing = [inside[a] != inside[b] for a, b in MC_EDGES]
        # contour segments per face
        segs = []
        for quad in _FACES:
            fedges = [_EDGE_ID[(quad[i], quad[(i + 1) % 4])]
                      for i in range(4)]
            cross = [e for e in fedges if crossing[e]]
            if len(cross) == 2:
                segs.append((cross[0], cross[1]))
            elif len(cross) == 4:
                # ambiguous face: diagonal signs. Connect the two edges
                # adjacent to each POSITIVE corner (mirror-symmetric ->
                # neighboring cells agree on the shared face).
                for i in range(4):
                    c = quad[i]
                    if inside[c]:
                        e_prev = _EDGE_ID[(quad[(i - 1) % 4], c)]
                        e_next = _EDGE_ID[(c, quad[(i + 1) % 4])]
                        segs.append((e_prev, e_next))
        # trace loops: every crossing edge appears in exactly 2 segments
        adj = {}
        for a, b in segs:
            adj.setdefault(a, []).append(b)
            adj.setdefault(b, []).append(a)
        visited = set()
        loops = []
        for start in adj:
            if start in visited:
                continue
            loop = [start]
            visited.add(start)
            prev, cur = None, start
            while True:
                nxts = [n for n in adj[cur] if n != prev] or \
                    [n for n in adj[cur]]
                nxt = nxts[0]
                if nxt == start:
                    break
                loop.append(nxt)
                visited.add(nxt)
                prev, cur = cur, nxt
            loops.append(loop)
        # orient + fan-triangulate
        tris = []
        for loop in loops:
            pts = edge_mid[loop]
            # Newell normal
            n = np.zeros(3)
            for i in range(len(loop)):
                p, q = pts[i], pts[(i + 1) % len(loop)]
                n += np.cross(p, q)
            # direction from the loop's centroid toward the adjacent
            # inside corners
            d = np.zeros(3)
            for c in range(8):
                w = 1.0 if inside[c] else -1.0
                d += w * (corner_pos[c] - pts.mean(axis=0))
            if np.dot(n, d) > 0:      # normal must point AWAY from inside
                loop = loop[::-1]
            for i in range(1, len(loop) - 1):
                tris.append((loop[0], loop[i], loop[i + 1]))
        assert len(tris) <= MC_MAX_TRIS, (case, len(tris))
        for t_i, t in enumerate(tris):
            tris_out[case, t_i] = t
    return tris_out


MC_CASE_TRIS = _build_tables()     # [256, MC_MAX_TRIS, 3] edge ids / -1
