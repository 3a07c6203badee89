"""Kernel K5: a row gather by index, beside its plain version.

K5 is the counterpart of the Pallas kernel of
``benchmarks/vmem_gather_probe.py`` (``build()``, bodies ``kernel_vec``
and ``kernel_loop``): ``out[i] = feat[idx[i]]`` for a feature map feat
[rows, C] and int32 indices idx [n]. The variant names are the probe's:
``"vec"`` copies each row with one thread per 16-byte vector, ``"loop"``
gives each block 512 indices, loads them into shared memory and copies
its rows through shared memory (``csrc/row_gather.cu``).

Indices must lie in [0, rows). Outside that range the two differ, and
neither reads outside ``feat``: the kernel writes a row of zeros, the
plain version (``feat[idx.long()]``, Python indexing) raises for an
index >= rows and counts a negative one from the end.
"""

from __future__ import annotations

import ctypes

import torch

VARIANTS = ("vec", "loop")
# indices per block of the loop variant (csrc/row_gather.cu, BLOCK)
LOOP_BLOCK = 512
# the loop variant stages at least one row in each of its two
# shared-memory sub-tiles
LOOP_MAX_ROW_BYTES = 65536
_INT_MAX = 2 ** 31 - 1


def row_gather_ref(feat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K5: feat [rows, C], idx [n] -> [n, C]."""
    return feat[idx.long()]


def _check(feat: torch.Tensor, idx: torch.Tensor, variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    if feat.dim() != 2 or not feat.is_contiguous():
        raise ValueError(f"feat must be a contiguous 2-D map, got "
                         f"{tuple(feat.shape)}")
    if feat.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"feat must be bfloat16 or float32, got "
                         f"{feat.dtype}")
    row_bytes = feat.shape[1] * feat.element_size()
    if row_bytes == 0 or row_bytes % 16 or feat.data_ptr() % 16:
        raise ValueError(f"feat's rows ({row_bytes} bytes) and base must be "
                         "16-byte aligned")
    if variant == "loop" and row_bytes > LOOP_MAX_ROW_BYTES:
        raise ValueError(f"the loop variant takes rows of at most "
                         f"{LOOP_MAX_ROW_BYTES} bytes, got {row_bytes}")
    if idx.dim() != 1 or not idx.is_contiguous() or idx.dtype != torch.int32:
        raise ValueError(f"idx must be a contiguous 1-D int32 tensor, got "
                         f"{idx.dtype} {tuple(idx.shape)}")
    if idx.device != feat.device:
        raise ValueError(f"idx on {idx.device}, feat on {feat.device}")
    if max(feat.shape[0], idx.shape[0]) > _INT_MAX:
        raise ValueError("rows and indices are counted in int32")


def row_gather(feat: torch.Tensor, idx: torch.Tensor, variant: str = "vec"
               ) -> torch.Tensor:
    """Rows of ``feat`` [rows, C] (bfloat16 or float32, contiguous, rows
    of a multiple of 16 bytes on a 16-byte-aligned base) at ``idx`` [n]
    int32 -> [n, C] in feat's dtype, bit for bit. CUDA tensors launch
    kernel K5 in ``variant`` ("vec" or "loop"; counted in
    ``row_gather.launches``); CPU tensors take :func:`row_gather_ref`;
    anything else raises."""
    _check(feat, idx, variant)
    dev = feat.device
    if dev.type == "cpu":
        return row_gather_ref(feat, idx)
    if dev.type != "cuda":
        raise ValueError(f"K5 runs on CUDA or CPU tensors, not {dev}")
    out = torch.empty((idx.shape[0], feat.shape[1]), dtype=feat.dtype,
                      device=dev)
    if out.numel() == 0:
        return out
    lib = _kernel_lib()
    kind = "bf16" if feat.dtype == torch.bfloat16 else "f32"
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, f"surs_row_gather_{variant}_{kind}")(
            feat.data_ptr(), idx.data_ptr(), out.data_ptr(), feat.shape[0],
            feat.shape[1], idx.shape[0], stream)
    if rc != 0:
        raise RuntimeError("row_gather launch failed: "
                           + lib.surs_cuda_error_string(rc).decode())
    row_gather.launches += 1
    return out


row_gather.launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int


def _kernel_lib() -> ctypes.CDLL:
    from .cuda_build import load
    lib = load("row_gather")
    if not getattr(lib, "_surs_bound", False):
        for variant in VARIANTS:
            for kind in ("bf16", "f32"):
                fn = getattr(lib, f"surs_row_gather_{variant}_{kind}")
                fn.argtypes = [_P, _P, _P, _I, _I, _I, _P]
                fn.restype = ctypes.c_int
        lib.surs_cuda_error_string.argtypes = [ctypes.c_int]
        lib.surs_cuda_error_string.restype = ctypes.c_char_p
        lib._surs_bound = True
    return lib
