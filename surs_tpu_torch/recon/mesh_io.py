"""Mesh I/O (counterpart of ``surs_tpu/recon/mesh_io.py``).

``save_obj_mesh`` writes OBJ files through the port's host library
(``csrc/mesh_native.cpp``, bound in ``recon/native.py``), byte for byte
the JAX package's default writer: 4-decimal vertices and faces written
with the reference's winding swap ``f v0 v2 v1`` (1-based).
``save_obj_mesh_ref`` is the same format in numpy, the plain version the
tests hold the library to; the served path never takes it. ``load_obj``
reads an OBJ file through the library, ``load_obj_ref`` in Python.

The color branch's writers are the JAX package's, byte for byte:
``save_obj_mesh_with_color`` (``v x y z r g b`` lines, every value as
``'%.4f'`` prints it, through the library; ``save_obj_mesh_with_color_ref``
is its plain version) and ``save_obj_mesh_with_uv`` (``v`` and ``vt``
lines, ``f a/a c/c b/b`` faces). ``load_obj(with_colors=True)`` reads the
colors back, in Python. Also the training loop's colored PLY dumps of
occupancy and color samples."""

from __future__ import annotations

import numpy as np

from . import native


def save_obj_mesh(path: str, verts, faces) -> None:
    """verts [V, 3], faces [F, 3] (0-based) -> an OBJ file, through the
    host library; raises when it cannot be built or the write fails."""
    native.write_obj(path, verts, faces)


def save_obj_mesh_ref(path: str, verts, faces) -> None:
    """The plain version of :func:`save_obj_mesh`. Vertices round as
    the native writer (``csrc/mesh_native.cpp:fmt_fixed4``): ``|v| * 1e4
    + 0.5`` truncated, the sign taken from ``v < 0``. So a tie rounds
    away from zero (-0.40625 -> ``-0.4063``, where ``%.4f`` of the
    double gives ``-0.4062``), a small negative writes ``-0.0000`` and
    ``-0.0`` writes ``0.0000``. The values are pre-rounded that way, then
    ``%.4f`` prints the 4-decimal value exactly; one %-operation over the
    whole array instead of one per line."""
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


def save_obj_mesh_with_color(path: str, verts, faces, colors) -> None:
    """verts [V, 3], faces [F, 3] (0-based), colors [V, 3] in [0, 1] ->
    a colored OBJ file, through the host library
    (``surs_tpu/recon/mesh_io.py:40``)."""
    native.write_obj_color(path, verts, faces, colors)


def save_obj_mesh_with_color_ref(path: str, verts, faces, colors) -> None:
    """The plain version of :func:`save_obj_mesh_with_color`: one
    %-operation over the whole array, ``'%.4f'`` of the float64 values."""
    verts = np.asarray(verts, dtype=np.float64).reshape(-1, 3)
    colors = np.asarray(colors, dtype=np.float64).reshape(-1, 3)
    faces = np.asarray(faces, dtype=np.int64).reshape(-1, 3)
    if colors.shape[0] != verts.shape[0]:
        raise ValueError(f"{colors.shape[0]} colors for {verts.shape[0]} "
                         "vertices")
    v_txt = ("v %.4f %.4f %.4f %.4f %.4f %.4f\n" * verts.shape[0]) % tuple(
        np.concatenate([verts, colors], axis=1).ravel().tolist())
    f_txt = ("f %d %d %d\n" * faces.shape[0]) % tuple(
        (faces[:, [0, 2, 1]] + 1).ravel().tolist())
    with open(path, "w") as f:
        f.write(v_txt)
        f.write(f_txt)


def save_obj_mesh_with_uv(path: str, verts, faces, uvs) -> None:
    """verts [V, 3], faces [F, 3] (0-based), per-vertex uvs [V, 2] -> an
    OBJ file with a ``vt`` line after each ``v`` line and faces
    ``f a/a c/c b/b`` (``surs_tpu/recon/mesh_io.py:51``)."""
    verts = np.asarray(verts, dtype=np.float64).reshape(-1, 3)
    uvs = np.asarray(uvs, dtype=np.float64).reshape(-1, 2)
    faces = np.asarray(faces, dtype=np.int64).reshape(-1, 3)
    n = min(verts.shape[0], uvs.shape[0])
    v_txt = ("v %.4f %.4f %.4f\nvt %.4f %.4f\n" * n) % tuple(
        np.concatenate([verts[:n], uvs[:n]], axis=1).ravel().tolist())
    f_txt = ("f %d/%d %d/%d %d/%d\n" * faces.shape[0]) % tuple(
        np.repeat(faces[:, [0, 2, 1]] + 1, 2, axis=1).ravel().tolist())
    with open(path, "w") as f:
        f.write(v_txt)
        f.write(f_txt)


def load_obj(path: str, with_colors: bool = False):
    """An OBJ file -> (verts [V, 3] float32, faces [F, 3] int64), through
    the host library: polygons fan-triangulated, indices 1-based or
    negative, ``v/vt/vn`` face tokens. ``with_colors=True`` reads in
    Python (:func:`load_obj_ref`) and also returns the ``v x y z r g b``
    colors [V, 3] float32, or None unless every vertex has one."""
    if with_colors:
        return load_obj_ref(path, with_colors=True)
    return native.read_obj(path)


def load_obj_ref(path: str, with_colors: bool = False):
    """The plain version of :func:`load_obj`
    (``surs_tpu/recon/mesh_io.py:load_obj``)."""
    verts, faces, colors = [], [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append((float(parts[1]), float(parts[2]),
                              float(parts[3])))
                if with_colors and len(parts) >= 7:
                    colors.append((float(parts[4]), float(parts[5]),
                                   float(parts[6])))
            elif line.startswith("f "):
                idx = [int(p.split("/")[0]) for p in line.split()[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):
                    faces.append((idx[0], idx[k], idx[k + 1]))
    v = np.asarray(verts, dtype=np.float32).reshape(-1, 3)
    f_arr = np.asarray(faces, dtype=np.int64).reshape(-1, 3)
    if with_colors:
        c = (np.asarray(colors, dtype=np.float32).reshape(-1, 3)
             if len(colors) == len(verts) else None)
        return v, f_arr, c
    return v, f_arr


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


def save_samples_rgb(path: str, points, rgb) -> None:
    """Colored PLY of points with rgb in [0, 1] (counterpart of
    ``save_samples_rgb``, ``surs_tpu/recon/mesh_io.py:83``)."""
    data = np.concatenate([np.asarray(points), np.asarray(rgb) * 255],
                          axis=-1)
    np.savetxt(path, data, fmt="%.6f %.6f %.6f %d %d %d", comments="",
               header=_PLY_HEADER.format(np.asarray(points).shape[0]))
