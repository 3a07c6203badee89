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
failed build raises. The JAX package's ``winding_number`` is a
``lax.scan`` that XLA fuses on the TPU; it reaches no ``pallas_call``,
so this kernel is the port's counterpart of an XLA fusion.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import numpy as np
import torch

from ..config import resolve_device

# csrc/winding_number.cu: points a block, triangles a shared-memory tile
THREADS = 128
TILE = 256
# blocks the plan aims for on each SM: 16 blocks of 128 threads fill one
BLOCKS_PER_SM = 16
_MAX_SPLITS = 65535
_INT_MAX = 2 ** 31 - 1
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


def winding_plan(n_points: int, n_tris: int, sms: int) -> Tuple[int, int]:
    """(splits, tiles a split) of the kernel's launch: the triangles'
    tiles of TILE go in contiguous shares to ``splits`` blocks a column of
    points (grid.y), enough for about BLOCKS_PER_SM blocks on each of
    ``sms`` SMs, and no share is empty."""
    tiles = -(-n_tris // TILE)
    columns = -(-n_points // THREADS)
    want = -(-sms * BLOCKS_PER_SM // max(1, columns))
    splits = max(1, min(tiles, want, _MAX_SPLITS))
    per = -(-tiles // splits)
    return -(-tiles // per), per


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
    if max(points.shape[0], 9 * tris.shape[0]) > _INT_MAX:
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
        splits, per = winding_plan(points.shape[0], tris.shape[0], _sms(dev))
        partial = torch.empty((splits if splits > 1 else 0,
                               points.shape[0]), dtype=torch.float32,
                              device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.surs_winding_number(
            points.data_ptr(), tris.data_ptr(), partial.data_ptr(),
            out.data_ptr(), points.shape[0], tris.shape[0], splits, per,
            stream)
    if rc != 0:
        raise RuntimeError("winding_number launch failed: "
                           + lib.surs_cuda_error_string(rc).decode())
    winding_number.launches += 1
    return out


winding_number.launches = 0

# per device: its SM count; a side stream for contains
_SMS: Dict[int, int] = {}
_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def _sms(dev: torch.device) -> int:
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _SMS[dev.index]


def _side_stream(dev: torch.device) -> "torch.cuda.Stream":
    if dev.index not in _STREAMS:
        _STREAMS[dev.index] = torch.cuda.Stream(dev)
    return _STREAMS[dev.index]


def contains(points, verts, faces, device=None) -> np.ndarray:
    """Boolean inside / outside of points [P, 3] with respect to the
    triangle mesh (verts [V, 3], faces [F, 3]): |winding number| > pi, a
    numpy bool array [P]. Runs on ``device``: CUDA unless named (raises
    without a GPU), ``"cpu"`` for the plain version. On CUDA the copies
    and the kernel run on a stream of this module's own for the device,
    which alone is waited for, so a loader thread's containment does not
    queue behind the work on the caller's stream."""
    dev = resolve_device(device)
    tris = torch.from_numpy(np.ascontiguousarray(
        np.asarray(verts, np.float32)[np.asarray(faces)]))
    pts = torch.from_numpy(np.ascontiguousarray(points, dtype=np.float32))
    if dev.type != "cuda":
        w = winding_number(pts.to(dev), tris.to(dev))
        return (w.abs() > THRESHOLD).cpu().numpy()
    dev = torch.device("cuda", dev.index if dev.index is not None
                       else torch.cuda.current_device())
    stream = _side_stream(dev)
    with torch.cuda.stream(stream):
        w = winding_number(pts.to(dev), tris.to(dev))
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
        lib.surs_cuda_error_string.argtypes = [ctypes.c_int]
        lib.surs_cuda_error_string.restype = ctypes.c_char_p
        lib._surs_bound = True
    return lib
