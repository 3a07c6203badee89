"""Kernel K5: a row gather by index, beside its plain versions.

K5 is the counterpart of the Pallas kernel of
``benchmarks/vmem_gather_probe.py`` (``build()``, bodies ``kernel_vec``
and ``kernel_loop``): ``out[i] = feat[idx[i]]`` for a feature map feat
[rows, C] and int32 indices idx [n]. The variant names are the probe's:
``"vec"`` copies rows through registers, each warp 32 rows at a time
with several 16-byte loads in flight per lane; ``"loop"`` copies each
row with one bulk copy into a shared-memory ring and writes each tile of
rows back with one bulk store (``csrc/row_gather.cu``). Both run on a
persistent grid planned here (:func:`row_gather_plan`) from the card's
SM count and the blocks that fit on one SM.

Indices must lie in [0, rows). Outside that range the kernel writes a
row of zeros and reads nothing outside ``feat``; the plain version
``row_gather_ref`` (``feat[idx.long()]``, Python indexing) raises for an
index >= rows and counts a negative one from the end;
``row_gather_tiled_ref`` walks the kernel's order and writes the
kernel's zeros.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

VARIANTS = ("vec", "loop")
# csrc/row_gather.cu: threads a block, 16-byte loads in flight a lane and
# rows a warp takes at a time in vec; one warp a block in loop
VEC_THREADS = 256
VEC_UNROLL = 8
VEC_BATCH = 32
LOOP_THREADS = 32
# loop's tile: about LOOP_STAGE_BYTES of rows, at most 4 rows a lane; its
# ring: about LOOP_RING_BYTES, 3 to 8 stages (the loads run stages - 2
# tiles ahead of the stores), behind 128 bytes of mbarriers
LOOP_STAGE_BYTES = 8192
LOOP_MAX_TILE = 128
LOOP_RING_BYTES = 32768
LOOP_MIN_STAGES = 3
LOOP_MAX_STAGES = 8
LOOP_BARRIER_BYTES = 128
# the dynamic shared memory one block may take on an H100 (227 KB)
SMEM_PER_BLOCK = 232448
# an mbarrier counts at most 2^20 - 1 bytes in flight
TX_LIMIT = 1 << 20
# three one-row stages of the largest row fit SMEM_PER_BLOCK
LOOP_MAX_ROW_BYTES = 65536
_INT_MAX = 2 ** 31 - 1


@dataclass(frozen=True)
class GatherPlan:
    """One launch of K5: ``grid`` blocks of ``threads``; in loop, tiles of
    ``tile_rows`` rows through ``stages`` ring stages of ``stage_bytes``,
    ``smem_bytes`` of dynamic shared memory a block."""
    variant: str
    grid: int
    threads: int
    tile_rows: int = 0
    stages: int = 0
    stage_bytes: int = 0
    smem_bytes: int = 0


def loop_tile(row_bytes: int) -> Tuple[int, int]:
    """(rows a tile, stages of the ring) of the loop variant for rows of
    ``row_bytes``."""
    tile = max(1, min(LOOP_MAX_TILE, LOOP_STAGE_BYTES // row_bytes))
    stages = max(LOOP_MIN_STAGES, min(LOOP_MAX_STAGES,
                                      LOOP_RING_BYTES // (tile * row_bytes)))
    return tile, stages


def loop_smem(row_bytes: int) -> int:
    """Dynamic shared memory of one loop block: barriers, then the ring."""
    tile, stages = loop_tile(row_bytes)
    return LOOP_BARRIER_BYTES + stages * tile * row_bytes


def row_gather_plan(n: int, row_bytes: int, variant: str, sms: int,
                    blocks_per_sm: int) -> GatherPlan:
    """The launch of K5 for ``n`` rows of ``row_bytes``: a persistent grid
    of at most ``sms * blocks_per_sm`` blocks (all resident at once), and
    no more than the work fills. vec gives each lane about VEC_UNROLL
    vectors; loop gives each block at least one tile."""
    if sms < 1 or blocks_per_sm < 1:
        raise ValueError(f"no block of K5's {variant} fits the card "
                         f"({sms} SMs x {blocks_per_sm})")
    most = sms * blocks_per_sm
    if variant == "vec":
        vectors = n * (row_bytes // 16)
        grid = -(-vectors // (VEC_THREADS * VEC_UNROLL))
        return GatherPlan("vec", max(1, min(most, grid)), VEC_THREADS)
    if variant != "loop":
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    tile, stages = loop_tile(row_bytes)
    tiles = -(-n // tile)
    return GatherPlan("loop", max(1, min(most, tiles)), LOOP_THREADS, tile,
                      stages, tile * row_bytes, loop_smem(row_bytes))


def plan_spans(plan: GatherPlan, n: int) -> Iterator[Tuple[int, int, int]]:
    """(block, first row, rows) of every piece the kernel copies, in its
    order: in vec each warp's batches of up to 32 rows, in loop each
    block's tiles. Every row lies in exactly one span."""
    if plan.variant == "vec":
        per = plan.threads // 32
        warps = plan.grid * per
        for w in range(warps):
            begin, end = w * n // warps, (w + 1) * n // warps
            for b in range(begin, end, VEC_BATCH):
                yield w // per, b, min(VEC_BATCH, end - b)
        return
    tiles = -(-n // plan.tile_rows)
    for c in range(plan.grid):
        for t in range(c * tiles // plan.grid,
                       (c + 1) * tiles // plan.grid):
            row0 = t * plan.tile_rows
            yield c, row0, min(plan.tile_rows, n - row0)


def row_gather_ref(feat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K5: feat [rows, C], idx [n] -> [n, C]."""
    return feat[idx.long()]


@functools.lru_cache(maxsize=64)
def vec_walk(vecs: int, total: int) -> Tuple[np.ndarray, np.ndarray]:
    """(row, vector) of each of the ``total`` flat 16-byte vectors of a
    vec batch of rows of ``vecs`` vectors, as the kernel's lanes step to
    them: lane l starts at flat vector l and moves 32 at a time by a
    precomputed quotient and remainder."""
    q, rm = 32 // vecs, 32 % vecs
    lanes = np.arange(32)
    row, v = lanes // vecs, lanes % vecs
    rows_at = np.empty(-(-total // 32) * 32, dtype=np.int64)
    vecs_at = np.empty_like(rows_at)
    for step in range(len(rows_at) // 32):
        rows_at[32 * step:32 * step + 32] = row
        vecs_at[32 * step:32 * step + 32] = v
        v = v + rm
        row = row + q + (v >= vecs)
        v = np.where(v >= vecs, v - vecs, v)
    return rows_at[:total], vecs_at[:total]


def row_gather_tiled_ref(feat: torch.Tensor, idx: torch.Tensor,
                         plan: GatherPlan) -> torch.Tensor:
    """Plain version of K5 that walks the kernel's order (:func:`plan_spans`)
    and writes the kernel's row of zeros for an index outside [0, rows).
    vec: each batch's 16-byte vectors in :func:`vec_walk`'s order. loop:
    each block's tiles through a ring of ``plan.stages`` stages, loads
    ``stages - 2`` tiles ahead of the stores, each tile stored whole."""
    rows, n = feat.shape[0], idx.shape[0]
    vecs = feat.shape[1] * feat.element_size() // 16
    src = feat.view(torch.uint8).view(rows, vecs, 16)
    out = torch.empty((n, vecs, 16), dtype=torch.uint8, device=feat.device)

    def gathered(r):
        r = r.long()
        inside = (r >= 0) & (r < rows)
        got = src[torch.where(inside, r, torch.zeros_like(r))]
        return torch.where(inside[:, None, None], got, torch.zeros_like(got))

    spans = list(plan_spans(plan, n))
    if plan.variant == "vec":
        flat = out.view(n * vecs, 16)
        for _, row0, cnt in spans:
            rr, vv = (torch.from_numpy(a) for a in vec_walk(vecs, cnt * vecs))
            r = idx[row0 + rr].long()
            inside = (r >= 0) & (r < rows)
            got = src[torch.where(inside, r, torch.zeros_like(r)), vv]
            flat[row0 * vecs + torch.arange(cnt * vecs)] = torch.where(
                inside[:, None], got, torch.zeros_like(got))
    else:
        ring = torch.empty((plan.stages, plan.tile_rows, vecs, 16),
                           dtype=torch.uint8, device=feat.device)
        ahead = plan.stages - 2
        for block in range(plan.grid):
            tiles = [(r0, c) for b, r0, c in spans if b == block]

            def issue(k):
                r0, c = tiles[k]
                ring[k % plan.stages, :c] = gathered(idx[r0:r0 + c])

            for k in range(min(ahead, len(tiles))):
                issue(k)
            for k, (r0, c) in enumerate(tiles):
                out[r0:r0 + c] = ring[k % plan.stages, :c]
                if k + ahead < len(tiles):
                    issue(k + ahead)
    return out.view(torch.uint8).view(-1).view(feat.dtype).view(
        n, feat.shape[1])


def check_plan(plan: GatherPlan, row_bytes: int) -> None:
    """Raise if the kernel would refuse ``plan`` for rows of
    ``row_bytes`` (csrc/row_gather.cu checks the same)."""
    if plan.grid < 1:
        raise ValueError(f"a plan of {plan.grid} blocks")
    if plan.variant == "vec":
        return
    tile_bytes = plan.tile_rows * row_bytes
    if not (1 <= plan.tile_rows <= LOOP_MAX_TILE
            and LOOP_MIN_STAGES <= plan.stages <= LOOP_MAX_STAGES
            and plan.stage_bytes == tile_bytes < TX_LIMIT
            and plan.smem_bytes == LOOP_BARRIER_BYTES
            + plan.stages * tile_bytes <= SMEM_PER_BLOCK):
        raise ValueError(f"the loop kernel takes no {plan} for rows of "
                         f"{row_bytes} bytes")


def _check(feat: torch.Tensor, idx: torch.Tensor, variant: str,
           plan: Optional[GatherPlan]) -> None:
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
    if plan is not None:
        if plan.variant != variant:
            raise ValueError(f"a {plan.variant} plan for variant {variant}")
        check_plan(plan, row_bytes)


def device_plan(feat: torch.Tensor, n: int, variant: str) -> GatherPlan:
    """:func:`row_gather_plan` for ``n`` rows of ``feat`` on its CUDA
    device, from that device's SM count and the kernel's occupancy (both
    asked once per device and kernel)."""
    dev = feat.device
    row_bytes = feat.shape[1] * feat.element_size()
    smem = loop_smem(row_bytes) if variant == "loop" else 0
    kind = "bf16" if feat.dtype == torch.bfloat16 else "f32"
    return row_gather_plan(n, row_bytes, variant, _sms(dev),
                           _occupancy(dev, variant, kind, smem))


def row_gather(feat: torch.Tensor, idx: torch.Tensor, variant: str = "vec",
               plan: Optional[GatherPlan] = None) -> torch.Tensor:
    """Rows of ``feat`` [rows, C] (bfloat16 or float32, contiguous, rows
    of a multiple of 16 bytes on a 16-byte-aligned base) at ``idx`` [n]
    int32 -> [n, C] in feat's dtype, bit for bit. CUDA tensors launch
    kernel K5 in ``variant`` ("vec" or "loop"; counted in
    ``row_gather.launches``) with :func:`device_plan`'s launch, or
    ``plan`` where one is given (a probe's sweep); CPU tensors take
    :func:`row_gather_ref`; anything else raises."""
    _check(feat, idx, variant, plan)
    dev = feat.device
    if dev.type == "cpu":
        return row_gather_ref(feat, idx)
    if dev.type != "cuda":
        raise ValueError(f"K5 runs on CUDA or CPU tensors, not {dev}")
    out = torch.empty((idx.shape[0], feat.shape[1]), dtype=feat.dtype,
                      device=dev)
    if out.numel() == 0:
        return out
    launch(_kernel_lib(), feat, idx, out, variant, plan)
    row_gather.launches += 1
    return out


row_gather.launches = 0


def launch(lib: ctypes.CDLL, feat: torch.Tensor, idx: torch.Tensor,
           out: torch.Tensor, variant: str,
           plan: Optional[GatherPlan] = None) -> None:
    """Launch ``variant`` of K5 from ``lib`` (the built ``row_gather.cu``
    or a probe's variant of it, bound by :func:`bind`) on checked CUDA
    tensors, into ``out``; raises if the launch fails."""
    kind = "bf16" if feat.dtype == torch.bfloat16 else "f32"
    with torch.cuda.device(feat.device):
        if plan is None:
            plan = device_plan(feat, idx.shape[0], variant)
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        args = [feat.data_ptr(), idx.data_ptr(), out.data_ptr(),
                feat.shape[0], feat.shape[1], idx.shape[0], plan.grid]
        if variant == "loop":
            args += [plan.tile_rows, plan.stages]
        rc = getattr(lib, f"surs_row_gather_{variant}_{kind}")(*args, stream)
    if rc != 0:
        raise RuntimeError("row_gather launch failed: "
                           + lib.surs_cuda_error_string(rc).decode())

_P, _I = ctypes.c_void_p, ctypes.c_int
# per device: its SM count; each kernel's blocks an SM at a shared-memory
# size; the loop kernels allowed their shared memory
_SMS = {}
_OCCUPANCY = {}
_ALLOWED = set()


def _sms(dev: torch.device) -> int:
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _SMS[dev.index]


def _occupancy(dev: torch.device, variant: str, kind: str, smem: int) -> int:
    key = (dev.index, variant, kind, smem)
    if key not in _OCCUPANCY:
        lib = _kernel_lib()
        blocks = ctypes.c_int(0)
        with torch.cuda.device(dev):
            rc = 0
            if variant == "loop" and (dev.index, kind) not in _ALLOWED:
                rc = lib.surs_row_gather_allow_smem(int(kind == "f32"))
                _ALLOWED.add((dev.index, kind))
            if rc == 0:
                rc = lib.surs_row_gather_occupancy(
                    int(variant == "loop"), int(kind == "f32"), smem,
                    ctypes.byref(blocks))
        if rc != 0:
            raise RuntimeError("row_gather occupancy query failed: "
                               + lib.surs_cuda_error_string(rc).decode())
        _OCCUPANCY[key] = blocks.value
    return _OCCUPANCY[key]


def _kernel_lib() -> ctypes.CDLL:
    from .cuda_build import load
    return bind(load("row_gather"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a built ``row_gather.cu``) with its C entries typed."""
    if not getattr(lib, "_surs_bound", False):
        for kind in ("bf16", "f32"):
            vec = getattr(lib, f"surs_row_gather_vec_{kind}")
            vec.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P]
            vec.restype = ctypes.c_int
            loop = getattr(lib, f"surs_row_gather_loop_{kind}")
            loop.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
            loop.restype = ctypes.c_int
        lib.surs_row_gather_occupancy.argtypes = [
            _I, _I, _I, ctypes.POINTER(ctypes.c_int)]
        lib.surs_row_gather_occupancy.restype = ctypes.c_int
        lib.surs_row_gather_allow_smem.argtypes = [_I]
        lib.surs_row_gather_allow_smem.restype = ctypes.c_int
        lib.surs_cuda_error_string.argtypes = [ctypes.c_int]
        lib.surs_cuda_error_string.restype = ctypes.c_char_p
        lib._surs_bound = True
    return lib
