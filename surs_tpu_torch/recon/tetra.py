"""Marching tetrahedra in torch, on whatever device the field lives on
(counterpart of ``surs_tpu/recon/tetra.py:87-162``, over the port's own
copy of its tables).

Each cube splits into 6 tetrahedra sharing the main diagonal v0-v6; every
tet case reduces to one or two triangles whose vertices are linear
interpolations along tet edges (the cube's axis edges and its face and
body diagonals). Vertices are welded on global edge keys, so the mesh is
watertight. The result equals the numpy function array for array: the
vertices in sorted edge-key order, the faces in (tet, slot, cell)
emission order, each vertex interpolated in float64 from the last
triangle corner that names its edge (``recon/marching.py``'s welding,
shared with marching cubes). On the CPU this function is the plain
version; on the card it is the device extractor of the eval path
(``Reconstructor.extract_pair``). Edge keys are ``lo * X*Y*Z + hi`` in
int64: about 1.8e16 at 512^3.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .marching import _case_ends, march

# 6-tetrahedra decomposition of the unit cube around diagonal v0-v6, in
# the cube corner numbering of mc_tables._CORNER_OFFSETS
_TETS = np.array([
    [0, 5, 1, 6],
    [0, 1, 2, 6],
    [0, 2, 3, 6],
    [0, 3, 7, 6],
    [0, 7, 4, 6],
    [0, 4, 5, 6],
], dtype=np.int64)

# tet edges by local vertex pair
_TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int64)

# for each of the 16 inside/outside cases (bit i == tet vertex i inside),
# up to 2 triangles of tet-edge ids (-1 padded)
_CASE_TRIS = -np.ones((16, 2, 3), dtype=np.int64)
_CASE_TRIS[1, 0] = (0, 1, 2)
_CASE_TRIS[2, 0] = (0, 4, 3)
_CASE_TRIS[3, 0] = (1, 2, 4)
_CASE_TRIS[3, 1] = (1, 4, 3)
_CASE_TRIS[4, 0] = (1, 3, 5)
_CASE_TRIS[5, 0] = (0, 3, 5)
_CASE_TRIS[5, 1] = (0, 5, 2)
_CASE_TRIS[6, 0] = (0, 1, 5)
_CASE_TRIS[6, 1] = (0, 5, 4)
_CASE_TRIS[7, 0] = (2, 4, 5)
_CASE_TRIS[8, 0] = (2, 5, 4)
_CASE_TRIS[9, 0] = (0, 5, 4)
_CASE_TRIS[9, 1] = (0, 1, 5)
_CASE_TRIS[10, 0] = (0, 5, 3)
_CASE_TRIS[10, 1] = (0, 2, 5)
_CASE_TRIS[11, 0] = (1, 5, 3)
_CASE_TRIS[12, 0] = (1, 4, 2)
_CASE_TRIS[12, 1] = (1, 3, 4)
_CASE_TRIS[13, 0] = (0, 3, 4)
_CASE_TRIS[14, 0] = (0, 2, 1)

# one emission group a tet: its 4 cube corners and its case table as
# cube-corner pairs
TET_GROUPS = [(tet.tolist(), _case_ends(tet, _CASE_TRIS, _TET_EDGES))
              for tet in _TETS]


def marching_tetrahedra(volume: torch.Tensor, level: float, **caps
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Isosurface ``volume == level`` of an [X, Y, Z] field (inside where
    the value > level): (verts [V, 3] float32 grid coordinates, faces
    [F, 3] int64) on the field's device. ``caps``: ``cell_chunk`` (cells
    emitted at once; the result does not change) and the capacities
    ``max_cells``, ``max_tris``, ``max_verts``, ``max_pts`` (None: no
    limit; exceeded: ``marching.CapacityError``), and ``stats``, which
    counts the host's waits on the card (:func:`marching.march`)."""
    return march(volume, level, TET_GROUPS, "marching_tetrahedra", **caps)
