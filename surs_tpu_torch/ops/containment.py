"""Point-in-mesh containment by generalized winding numbers (counterpart
of ``surs_tpu/ops/containment.py``), beside its plain version.

The winding number sums the solid angle each triangle subtends at a
point (van Oosterom and Strackee): about 4 pi inside a watertight mesh
and 0 outside. ``contains`` cuts at |w| > pi, as the JAX package does
(``containment.py:83``): winding number 0.25, lenient to the cracks and
open seams of scanned meshes (Jacobson et al. 2013 cut at half the
maximum too).

``winding_number`` launches the hand-written kernel
``csrc/winding_number.cu`` on CUDA tensors (counted in
``winding_number.launches``) and takes the plain version
``winding_number_ref`` on CPU tensors; anything else raises, and a
failed build raises. The kernel reads the triangles as 16-byte-aligned
records (``pack_triangles``, built on the card) and takes approximate
square roots and its own arctangent (``ATAN_COEFFS``);
tests/test_torch_containment.py holds a numpy model of that arithmetic
to ``np.arctan2`` and to the plain version. The JAX package's
``winding_number`` is a ``lax.scan`` that XLA fuses on the TPU; it
reaches no ``pallas_call``, so this kernel is the port's counterpart of
an XLA fusion.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import numpy as np
import torch

from ..config import resolve_device

# csrc/winding_number.cu: threads and points a block, triangle records
# a shared-memory tile; a record is 12 floats (A, B, C, each padded to 4)
THREADS = 128
POINTS_PER_THREAD = 4
BLOCK_POINTS = THREADS * POINTS_PER_THREAD
TILE = 128
RECORD_FLOATS = 12
# the plan spreads the blocks over at most this many waves of the
# kernel's resident blocks
MAX_WAVES = 4
_MAX_SPLITS = 65535
_INT_MAX = 2 ** 31 - 1
# the kernel's arctangent: atan(r) / r ~ P(r^2) on [0, 1], P's
# coefficients from the constant term up (winding_number.cu, ATAN_C0-7)
ATAN_COEFFS = (0.999999881, -0.333319902, 0.199697301, -0.140195221,
               0.0991442278, -0.0594884418, 0.0242539942, -0.00469375867)
# the plain version's chunks: [points, triangles] intermediates of at
# most 1,024 x 2,048 pairs (8 MB a float32 [P, T] tensor, 25 MB a
# [P, T, 3] one)
REF_POINT_CHUNK = 1024
REF_TRI_CHUNK = 2048
# |w| > pi: inside
THRESHOLD = math.pi


def _solid_angle_sum(points: torch.Tensor, tris: torch.Tensor
                     ) -> torch.Tensor:
    """points [P, 3], tris [T, 3, 3] -> the summed solid angle [P]
    (``surs_tpu/ops/containment.py:32-44``)."""
    a = tris[None, :, 0, :] - points[:, None, :]   # [P, T, 3]
    b = tris[None, :, 1, :] - points[:, None, :]
    c = tris[None, :, 2, :] - points[:, None, :]
    la = torch.linalg.vector_norm(a, dim=-1)
    lb = torch.linalg.vector_norm(b, dim=-1)
    lc = torch.linalg.vector_norm(c, dim=-1)
    det = (a * torch.cross(b, c, dim=-1)).sum(-1)
    denom = (la * lb * lc + (a * b).sum(-1) * lc + (b * c).sum(-1) * la
             + (c * a).sum(-1) * lb)
    return (2.0 * torch.atan2(det, denom)).sum(-1)


def winding_number_ref(points: torch.Tensor, tris: torch.Tensor
                       ) -> torch.Tensor:
    """The plain version: points [P, 3], tris [T, 3, 3] float32 -> the
    winding value [P] float32 (about +-4 pi k), summed over chunks of
    REF_TRI_CHUNK triangles for chunks of REF_POINT_CHUNK points, so its
    memory stays bounded."""
    out = torch.zeros(points.shape[0], dtype=torch.float32,
                      device=points.device)
    for p0 in range(0, points.shape[0], REF_POINT_CHUNK):
        pts = points[p0:p0 + REF_POINT_CHUNK]
        acc = out[p0:p0 + REF_POINT_CHUNK]
        for t0 in range(0, tris.shape[0], REF_TRI_CHUNK):
            acc += _solid_angle_sum(pts, tris[t0:t0 + REF_TRI_CHUNK])
    return out


def winding_plan(n_points: int, n_tris: int, sms: int,
                 blocks_per_sm: int) -> Tuple[int, int]:
    """(splits, tiles a split) of the kernel's launch: the triangles'
    tiles of TILE go in contiguous shares to ``splits`` blocks a column
    of BLOCK_POINTS points (grid.y), no share empty. A block's time is
    its share's tiles, and the card runs ``sms`` x ``blocks_per_sm``
    blocks at once, so the plan takes the fewest splits that minimise
    waves x tiles a share, within MAX_WAVES waves (one split where the
    columns alone fill more)."""
    tiles = -(-n_tris // TILE)
    columns = -(-n_points // BLOCK_POINTS)
    slots = sms * blocks_per_sm
    best = None
    for want in range(1, max(1, min(tiles, _MAX_SPLITS,
                                    MAX_WAVES * slots // columns)) + 1):
        per = -(-tiles // want)
        splits = -(-tiles // per)
        cost = -(-columns * splits // slots) * per
        if best is None or cost < best[0]:
            best = (cost, splits, per)
    return best[1], best[2]


def pack_triangles(tris: torch.Tensor) -> torch.Tensor:
    """tris [T, 3, 3] -> the kernel's records [T, 3, 4] (A, B, C, each
    padded with a 0 to 16 bytes), on tris' device."""
    return torch.nn.functional.pad(tris, (0, 1))


def _check(points: torch.Tensor, tris: torch.Tensor) -> None:
    if points.dim() != 2 or points.shape[1] != 3:
        raise ValueError(f"points must be [P, 3], got {tuple(points.shape)}")
    if tris.dim() != 3 or tris.shape[1:] != (3, 3):
        raise ValueError(f"tris must be [T, 3, 3], got {tuple(tris.shape)}")
    for name, t in (("points", points), ("tris", tris)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32, got "
                             f"{t.dtype}")
    if tris.device != points.device:
        raise ValueError(f"tris on {tris.device}, points on {points.device}")
    if max(3 * points.shape[0], RECORD_FLOATS * tris.shape[0]) > _INT_MAX:
        raise ValueError("points and triangles are counted in int32")


def winding_number(points: torch.Tensor, tris: torch.Tensor) -> torch.Tensor:
    """Generalized winding number of each point [P, 3] with respect to
    the triangles [T, 3, 3] (float32, contiguous, one device) -> [P]
    float32. CUDA tensors launch the kernel on the current stream; CPU
    tensors take :func:`winding_number_ref`; anything else raises."""
    _check(points, tris)
    dev = points.device
    if dev.type == "cpu":
        return winding_number_ref(points, tris)
    if dev.type != "cuda":
        raise ValueError(f"the winding number runs on CUDA or CPU tensors, "
                         f"not {dev}")
    lib = _kernel_lib()
    out = torch.zeros(points.shape[0], dtype=torch.float32, device=dev)
    if points.shape[0] == 0 or tris.shape[0] == 0:
        return out
    with torch.cuda.device(dev):
        records = pack_triangles(tris)
        splits, per = winding_plan(points.shape[0], tris.shape[0],
                                   *_occupancy(dev, lib))
        partial = torch.empty((splits if splits > 1 else 0,
                               points.shape[0]), dtype=torch.float32,
                              device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.surs_winding_number(
            points.data_ptr(), records.data_ptr(), partial.data_ptr(),
            out.data_ptr(), points.shape[0], tris.shape[0], splits, per,
            stream)
    if rc != 0:
        raise RuntimeError("winding_number launch failed: "
                           + lib.surs_cuda_error_string(rc).decode())
    winding_number.launches += 1
    return out


winding_number.launches = 0

# per device: (its SM count, the kernel's resident blocks an SM); a side
# stream for contains
_OCCUPANCY: Dict[int, Tuple[int, int]] = {}
_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def _occupancy(dev: torch.device, lib: ctypes.CDLL) -> Tuple[int, int]:
    if dev.index not in _OCCUPANCY:
        blocks = ctypes.c_int(0)
        rc = lib.surs_winding_blocks_per_sm(ctypes.byref(blocks))
        if rc != 0 or blocks.value < 1:
            raise RuntimeError("winding_number occupancy query failed: "
                               + lib.surs_cuda_error_string(rc).decode())
        _OCCUPANCY[dev.index] = (torch.cuda.get_device_properties(
            dev).multi_processor_count, blocks.value)
    return _OCCUPANCY[dev.index]


def _side_stream(dev: torch.device) -> "torch.cuda.Stream":
    if dev.index not in _STREAMS:
        _STREAMS[dev.index] = torch.cuda.Stream(dev)
    return _STREAMS[dev.index]


def contains(points, verts, faces, device=None) -> np.ndarray:
    """Boolean inside / outside of points [P, 3] with respect to the
    triangle mesh (verts [V, 3], faces [F, 3]): |winding number| > pi, a
    numpy bool array [P]. Runs on ``device``: CUDA unless named (raises
    without a GPU), ``"cpu"`` for the plain version. On CUDA the points,
    the vertices and the faces (as int32) are copied to the card and the
    triangles gathered there, on a stream of this module's own for the
    device, which alone is waited for, so a loader thread's containment
    does not queue behind the work on the caller's stream."""
    dev = resolve_device(device)
    pts = torch.from_numpy(np.ascontiguousarray(points, dtype=np.float32))
    if dev.type != "cuda":
        tris = torch.from_numpy(np.ascontiguousarray(
            np.asarray(verts, np.float32)[np.asarray(faces)]))
        w = winding_number(pts.to(dev), tris.to(dev))
        return (w.abs() > THRESHOLD).cpu().numpy()
    dev = torch.device("cuda", dev.index if dev.index is not None
                       else torch.cuda.current_device())
    v = torch.from_numpy(np.ascontiguousarray(verts, dtype=np.float32))
    f = torch.from_numpy(np.ascontiguousarray(faces, dtype=np.int32))
    stream = _side_stream(dev)
    with torch.cuda.stream(stream):
        tris = v.to(dev)[f.to(dev)]
        w = winding_number(pts.to(dev), tris)
        inside = (w.abs() > THRESHOLD).cpu()
    return inside.numpy()


_P, _I = ctypes.c_void_p, ctypes.c_int


def _kernel_lib() -> ctypes.CDLL:
    from .cuda_build import load
    lib = load("winding_number")
    if not getattr(lib, "_surs_bound", False):
        lib.surs_winding_number.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I,
                                            _P]
        lib.surs_winding_number.restype = ctypes.c_int
        lib.surs_winding_blocks_per_sm.argtypes = [
            ctypes.POINTER(ctypes.c_int)]
        lib.surs_winding_blocks_per_sm.restype = ctypes.c_int
        lib.surs_cuda_error_string.argtypes = [ctypes.c_int]
        lib.surs_cuda_error_string.restype = ctypes.c_char_p
        lib._surs_bound = True
    return lib
