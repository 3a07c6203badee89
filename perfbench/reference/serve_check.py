"""The output check of the serving cells: the plain model in float32
(TF32 off) recomputes each checked subject's occupancy fields from the
image and the weights the benchmark made, and the served OBJ text is
judged against them (``check.py``). The control puts the plain model, in
a lower precision, in the program's place.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import check as chk
from . import model as ref
from . import octree

CHUNK = 1 << 17
CALIB = np.diag([2.0, -2.0, 2.0, 1.0]).astype(np.float32)


def normalize(img: np.ndarray, mask: np.ndarray):
    """uint8 image [S, S, 3] and silhouette [S, S] -> the masked image in
    [-1, 1] [1, S, S, 3] and the silhouette in {0, 1} [S, S]."""
    m = mask.astype(np.float32) / 255.0
    x = (img.astype(np.float32) / 255.0 - 0.5) / 0.5 * m[..., None]
    return x[None], m


class Fields:
    """The plain model's occupancy over one subject's grid."""

    def __init__(self, cfg, params, img, mask, device, mode: str):
        self.cfg = cfg
        self.R = cfg.resolution
        self.mat = octree.grid_matrix(self.R, cfg.b_min, cfg.b_max)
        self.dev = device
        self.mode = mode
        x, m = normalize(img, mask)
        self.calib = torch.tensor(CALIB[None], device=device)
        with ref.precision(mode), torch.no_grad():
            _, feats, self.feat_hr = ref.encode(
                torch.tensor(x, device=device), params, cfg.num_stack_lr)
        self.feat_lr = feats[-1]
        self.params = params
        self.mask = torch.tensor(m, device=device)
        self.full = None

    def points(self, pts: torch.Tensor):
        with ref.precision(self.mode), torch.no_grad():
            hr, lr = ref.query(self.feat_lr, self.feat_hr, pts[None],
                               self.calib, self.params, self.cfg.loadSize,
                               self.cfg.z_size)
        return hr[0], lr[0]

    def octree(self):
        c = self.cfg
        hr, lr, q = octree.octree_fields(
            self.points, self.R, self.mat, c.threshold,
            c.octree_init_resolution, CHUNK,
            mask=self.mask if c.mask_prune else None, calib=self.calib)
        self.full = (hr, lr)
        return q

    def at_nodes(self, nodes: np.ndarray, which: int) -> np.ndarray:
        n = torch.as_tensor(nodes, device=self.dev)
        if self.full is not None:
            f = self.full[which]
            return f[n[:, 0], n[:, 1], n[:, 2]].double().cpu().numpy()
        out = []
        for c0 in range(0, len(n), CHUNK):
            pts = octree.lattice_points(n[c0:c0 + CHUNK].T, 1, self.mat)
            out.append(self.points(pts)[which])
        if not out:
            return np.zeros(0)
        return torch.cat(out).double().cpu().numpy()

    def lines(self, axis: int, cols: np.ndarray):
        """(hr, lr) [C, R] along the grid lines of ``axis`` through
        ``cols`` [C, 2] (the other two coordinates, in order)."""
        c = torch.as_tensor(cols, device=self.dev)
        if self.full is not None:
            a, b = c[:, 0], c[:, 1]
            pick = {0: lambda f: f[:, a, b].T, 1: lambda f: f[a, :, b],
                    2: lambda f: f[a, b, :]}[axis]
            return [pick(f) for f in self.full]
        return list(octree.line_fields(self.points, c, axis, self.R,
                                       self.mat, CHUNK))


def control_meshes(fields: "Fields", lines, grid: chk.Grid):
    """The control's two meshes' vertices as the writer would round
    them: every crossing of its whole fields (octree), or of the sampled
    lines (dense)."""
    if fields.full is not None:
        return [chk.round_like_writer(grid.to_world(chk.crossings_3d(f)))
                for f in fields.full]
    out = [[], []]
    for axis, cols in lines:
        for which, f in enumerate(fields.lines(axis, cols)):
            idx, t = octree.crossings(f)
            c = idx[:, 0].cpu().numpy()
            g = np.zeros((len(c), 3))
            others = [a for a in range(3) if a != axis]
            g[:, others[0]] = cols[c, 0]
            g[:, others[1]] = cols[c, 1]
            g[:, axis] = idx[:, 1].double().add(t).cpu().numpy()
            out[which].append(g)
    return [chk.round_like_writer(grid.to_world(np.concatenate(v)))
            for v in out]


def judge(run, cfg, params, subjects: Sequence, check: Dict, expect: int,
          control: Optional[str] = None) -> Dict:
    """Judge the served subjects [(image, mask, [hr OBJ bytes, lr OBJ
    bytes])]; with ``control`` (a precision) the served meshes are the
    plain model's in that precision instead. Returns {"numbers": {name:
    value}, "info": {...}}: ``mesh_gap_p50`` and ``mesh_gap_p99``, the
    worst mesh's median and 99th percentile field gap; ``vertex_gap`` (the octree cells, whose whole field the
    reference has), the worst mesh's relative difference of vertex
    counts; ``column_gap``, the share of the reference's crossings along
    the sampled columns that the served meshes miss, with the served
    vertices there that the reference does not cross; ``malformed``;
    ``unchecked``, the subjects due that were not judged."""
    dev = torch.device(run.device)
    rng = np.random.default_rng(run.seed + 2)
    grid = chk.Grid(cfg.resolution, cfg.b_min, cfg.b_max)
    dense = not cfg.use_octree
    gaps: List[np.ndarray] = []
    info: Dict = {"meshes": []}
    malformed = 0
    vertex_gap = 0.0
    mismatch = crossed = 0
    for img, mask, objs in subjects:
        base = Fields(cfg, params, img, mask, dev, "float32")
        if not dense:
            info.setdefault("ref_queries", []).append(base.octree())
        lines = []
        for axis in range(3):
            flat = rng.choice(grid.R * grid.R, min(int(check["columns"]),
                                                   grid.R * grid.R),
                              replace=False)
            lines.append((axis, np.stack([flat // grid.R,
                                          flat % grid.R], 1)))
        if control is None:
            meshes = []
            for buf in objs:
                try:
                    meshes.append(chk.parse_obj(buf, int(check["faces"]),
                                                rng))
                except ValueError:
                    malformed += 1
                    meshes.append((np.zeros((0, 3)), None, 0))
        else:
            low = Fields(cfg, params, img, mask, dev, control)
            if not dense:
                low.octree()
            meshes = [(v, None, 0) for v in control_meshes(low, lines,
                                                           grid)]
            del low
        line_fields = [(axis, cols, base.lines(axis, cols))
                       for axis, cols in lines]
        for which, (v, f, nf) in enumerate(meshes):
            res = chk.check_mesh(
                v, f, lambda n, w=which: base.at_nodes(n, w),
                [(a, c, lf[which]) for a, c, lf in line_fields], grid,
                int(check["vertices"]), rng)
            malformed += res["malformed"]
            mismatch += res["column_missed"] + res["column_extra"]
            crossed += res["column_crossings"]
            g = np.concatenate([res["vertex"], res["column"]])
            gaps.append(g)
            row = {"mesh": "hr" if which == 0 else "lr",
                   "vertices": res["n_vertices"], "faces": nf,
                   "column_edges": res["n_column_edges"],
                   "column_crossings": res["column_crossings"],
                   "column_missed": res["column_missed"],
                   "column_extra": res["column_extra"],
                   "malformed": res["malformed"]}
            for q in (50, 99, 99.9, 100):
                row[f"gap_p{q}"] = float(np.percentile(g, q)) if len(g) \
                    else 0.0
            if base.full is not None:
                f = base.full[which] > 0.5
                n_ref = sum(int((f.narrow(a, 0, grid.R - 1)
                                 != f.narrow(a, 1, grid.R - 1)).sum())
                            for a in range(3))
                row["ref_vertices"] = n_ref
                vertex_gap = max(vertex_gap, abs(len(v) - n_ref)
                                 / max(n_ref, 1))
            info["meshes"].append(row)
        del base, line_fields
    allg = np.concatenate(gaps) if gaps else np.zeros(0)
    numbers = {
        "mesh_gap_p50": max((float(np.median(g)) for g in gaps if len(g)),
                            default=0.0),
        "mesh_gap_p99": max((float(np.percentile(g, 99)) for g in gaps
                             if len(g)), default=0.0),
        "malformed": float(malformed),
        "unchecked": float(max(expect - len(subjects), 0)),
    }
    if not dense:
        numbers["vertex_gap"] = float(vertex_gap)
    numbers["column_gap"] = mismatch / max(crossed, 1)
    info["field_gap_max"] = float(allg.max()) if len(allg) else 0.0
    info["field_gap_p99"] = float(np.percentile(allg, 99)) if len(allg) \
        else 0.0
    if not all(math.isfinite(x) for x in numbers.values()):
        numbers["mesh_gap_p50"] = float("inf")
    return {"numbers": numbers, "info": info}
