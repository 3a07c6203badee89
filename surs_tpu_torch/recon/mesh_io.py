"""OBJ writer (counterpart of ``save_obj_mesh``,
``surs_tpu/recon/mesh_io.py:26-37``): byte-identical output, 4-decimal
vertices and faces written with the reference's winding swap
``f v0 v2 v1`` (1-based). The formatting is one %-operation over the
whole array instead of one per line: a 512^3 mesh has millions of
lines. Also the training loop's colored PLY dump of occupancy samples."""

from __future__ import annotations

import numpy as np


def save_obj_mesh(path: str, verts, faces) -> None:
    """Vertices round as the JAX package's default writer, the native
    one (``csrc/mesh_native.cpp:fmt_fixed4``): ``|v| * 1e4 + 0.5``
    truncated, the sign taken from ``v < 0``. So a tie rounds away from
    zero (-0.40625 -> ``-0.4063``, where ``%.4f`` of the double gives
    ``-0.4062``), a small negative writes ``-0.0000`` and ``-0.0`` writes
    ``0.0000``. The values are pre-rounded that way, then ``%.4f``
    prints the 4-decimal value exactly."""
    verts = np.asarray(verts, dtype=np.float64).reshape(-1, 3)
    faces = np.asarray(faces, dtype=np.int64).reshape(-1, 3)
    r = np.floor(np.abs(verts) * 1e4 + 0.5) / 1e4
    r = np.where(verts < 0, -r, r)
    v_txt = ("v %.4f %.4f %.4f\n" * verts.shape[0]) % tuple(
        r.ravel().tolist())
    f_txt = ("f %d %d %d\n" * faces.shape[0]) % tuple(
        (faces[:, [0, 2, 1]] + 1).ravel().tolist())
    with open(path, "w") as f:
        f.write(v_txt)
        f.write(f_txt)


_PLY_HEADER = ("ply\nformat ascii 1.0\nelement vertex {:d}\n"
               "property float x\nproperty float y\nproperty float z\n"
               "property uchar red\nproperty uchar green\n"
               "property uchar blue\nend_header")


def save_samples_truncted_prob(path: str, points, prob) -> None:
    """Colored PLY of occupancy samples, red where prob > 0.5 and green
    where prob < 0.5 (counterpart of ``save_samples_truncted_prob``,
    ``surs_tpu/recon/mesh_io.py:70``)."""
    points = np.asarray(points)
    prob = np.asarray(prob)
    r = (prob > 0.5).reshape(-1, 1) * 255
    g = (prob < 0.5).reshape(-1, 1) * 255
    b = np.zeros(r.shape)
    data = np.concatenate([points, r, g, b], axis=-1)
    np.savetxt(path, data, fmt="%.6f %.6f %.6f %d %d %d", comments="",
               header=_PLY_HEADER.format(points.shape[0]))
