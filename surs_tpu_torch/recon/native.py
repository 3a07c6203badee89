"""ctypes bindings of the port's host mesh library
(``csrc/mesh_native.cpp``, counterpart of ``surs_tpu/recon/native.py``):
marching tetrahedra, the OBJ writer and reader, and the colored OBJ
writer.

The library is built with the host C++ compiler at first use
(``ops/cuda_build.py``); a missing compiler or a failed build raises,
and so does a failed call: there is no fallback. ctypes releases the GIL
for the length of a call, so a write on one thread runs beside Python
work on another.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

from ..ops import cuda_build

_LIB: Optional[ctypes.CDLL] = None
_F32P = ctypes.POINTER(ctypes.c_float)
_F64P = ctypes.POINTER(ctypes.c_double)
_I64P = ctypes.POINTER(ctypes.c_int64)


def library() -> ctypes.CDLL:
    """The loaded host library with its signatures, built first if
    needed."""
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("mesh_native")
        lib.surs_write_obj.restype = ctypes.c_int
        lib.surs_write_obj.argtypes = [ctypes.c_char_p, _F64P,
                                       ctypes.c_int64, _I64P,
                                       ctypes.c_int64]
        lib.surs_write_obj_color.restype = ctypes.c_int
        lib.surs_write_obj_color.argtypes = [ctypes.c_char_p, _F64P, _F64P,
                                             ctypes.c_int64, _I64P,
                                             ctypes.c_int64]
        lib.surs_read_obj.restype = ctypes.c_int
        lib.surs_read_obj.argtypes = [ctypes.c_char_p, _F32P, _I64P, _I64P,
                                      _I64P]
        lib.surs_marching_tetrahedra.restype = ctypes.c_int
        lib.surs_marching_tetrahedra.argtypes = [
            _F32P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_float, ctypes.POINTER(_F32P), _I64P,
            ctypes.POINTER(_I64P), _I64P]
        lib.surs_free.argtypes = [ctypes.c_void_p]
        _LIB = lib
    return _LIB


def marching_tetrahedra(volume, level: float
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """The ``volume == level`` isosurface of an [X, Y, Z] field on the
    host (inside where the value > level): (verts [V, 3] float32 grid
    coordinates, faces [F, 3] int64), the vertices in first-appearance
    order, the faces cell by cell. The same mesh as ``recon/tetra.py``
    up to the order of its vertices and faces."""
    vol = np.ascontiguousarray(volume, dtype=np.float32)
    X, Y, Z = vol.shape
    lib = library()
    vp, fp = _F32P(), _I64P()
    nv, nf = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.surs_marching_tetrahedra(
        vol.ctypes.data_as(_F32P), X, Y, Z, ctypes.c_float(level),
        ctypes.byref(vp), ctypes.byref(nv), ctypes.byref(fp),
        ctypes.byref(nf))
    if rc != 0:
        raise MemoryError("marching tetrahedra: the host library could not "
                          "allocate the mesh")
    try:
        verts = np.ctypeslib.as_array(vp, shape=(nv.value, 3)).copy()
        faces = np.ctypeslib.as_array(fp, shape=(nf.value, 3)).copy()
    finally:
        lib.surs_free(vp)
        lib.surs_free(fp)
    return verts, faces


def write_obj(path: str, verts, faces) -> None:
    """verts [V, 3] (written from float64), faces [F, 3] 0-based ->
    the OBJ file at ``path``."""
    verts = np.ascontiguousarray(verts, dtype=np.float64).reshape(-1, 3)
    faces = np.ascontiguousarray(faces, dtype=np.int64).reshape(-1, 3)
    rc = library().surs_write_obj(
        os.fsencode(path), verts.ctypes.data_as(_F64P), verts.shape[0],
        faces.ctypes.data_as(_I64P), faces.shape[0])
    if rc != 0:
        raise OSError(f"{path}: the OBJ writer failed "
                      f"({'cannot open' if rc == 1 else 'write error'})")


def write_obj_color(path: str, verts, faces, colors) -> None:
    """verts [V, 3] and colors [V, 3] (written from float64), faces
    [F, 3] 0-based -> the colored OBJ file at ``path``, each value as
    ``'%.4f'`` prints it."""
    verts = np.ascontiguousarray(verts, dtype=np.float64).reshape(-1, 3)
    colors = np.ascontiguousarray(colors, dtype=np.float64).reshape(-1, 3)
    faces = np.ascontiguousarray(faces, dtype=np.int64).reshape(-1, 3)
    if colors.shape[0] != verts.shape[0]:
        raise ValueError(f"{colors.shape[0]} colors for {verts.shape[0]} "
                         "vertices")
    rc = library().surs_write_obj_color(
        os.fsencode(path), verts.ctypes.data_as(_F64P),
        colors.ctypes.data_as(_F64P), verts.shape[0],
        faces.ctypes.data_as(_I64P), faces.shape[0])
    if rc != 0:
        raise OSError(f"{path}: the OBJ writer failed "
                      f"({'cannot open' if rc == 1 else 'write error'})")


def read_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """An OBJ file -> (verts [V, 3] float32, faces [F, 3] int64,
    0-based), polygons fan-triangulated. Two calls of the library: the
    counts, then the arrays."""
    lib = library()
    p = os.fsencode(path)
    nv, nf = ctypes.c_int64(), ctypes.c_int64()
    if lib.surs_read_obj(p, None, ctypes.byref(nv), None,
                         ctypes.byref(nf)) != 0:
        raise OSError(f"{path}: cannot open the OBJ file")
    verts = np.empty((nv.value, 3), np.float32)
    faces = np.empty((nf.value, 3), np.int64)
    rc = lib.surs_read_obj(p, verts.ctypes.data_as(_F32P), ctypes.byref(nv),
                           faces.ctypes.data_as(_I64P), ctypes.byref(nf))
    if rc != 0:
        raise OSError(f"{path}: the OBJ file changed while it was read")
    return verts[:nv.value], faces[:nf.value]
