"""The benchmark's yardstick, frozen here so that a change to the
program cannot move it: the published peaks of one NVIDIA H100 SXM, the
operations and bytes of the occupancy MLP kernels computed from their
shapes, a roofline share, the device's busy time as the union of its
operations' intervals, and the model-FLOP share of a window (``mfu``).

Peaks (NVIDIA's data sheet, dense, at the 700 W limit): bf16 989 TFLOP/s,
TF32 495 TFLOP/s, float32 outside the tensor cores 67 TFLOP/s, HBM3
3.35 TB/s. A float32 product computed as 3xTF32 on the tensor cores is
three TF32 products: its work counts three times at the TF32 peak, never
once at the float32 peak, which the 3xTF32 kernels exceed.

Operations are the multiply-adds of the two occupancy MLPs (321 / 322 ->
1024 -> 512 -> 256 -> 128 -> 1, the input re-read by layers 2-4), 2 FLOP
each. The point kernels (K1, K2) run both MLPs for every point; the
column kernel (K3) runs the feature products once a column and only the
hidden chain for each depth. Bytes count each input read once and each
output written once.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
DIMS_LR = (321, 1024, 512, 256, 128, 1)
DIMS_HR = (322, 1024, 512, 256, 128, 1)
RES_LAYERS = (2, 3, 4)
FEATURES = 256 + 64


def _fan_ins(dims: Sequence[int]) -> List[int]:
    return [dims[i] + (dims[0] if i in RES_LAYERS else 0)
            for i in range(len(dims) - 1)]


def dual_mlp_macs() -> int:
    """Multiply-adds of both MLPs for one point."""
    return sum(f * d for dims in (DIMS_LR, DIMS_HR)
               for f, d in zip(_fan_ins(dims), dims[1:]))


def hidden_chain_macs() -> int:
    """Per depth sample of a column: the hidden part of every layer
    past the first, both MLPs."""
    return sum(dims[i] * dims[i + 1] for dims in (DIMS_LR, DIMS_HR)
               for i in range(1, len(dims) - 1))


def column_feature_macs() -> int:
    """Per column: the feature rows of every layer that reads the
    input, both MLPs."""
    return sum(FEATURES * dims[i + 1] for dims in (DIMS_LR, DIMS_HR)
               for i in range(len(dims) - 1) if i == 0 or i in RES_LAYERS)


def k1_work(n: int, dtype: str) -> Tuple[float, float]:
    """K1 on n points: x [n, 321] float32 read once, the weights once in
    ``dtype``, two float32 outputs."""
    wbytes = 2 if dtype == "bfloat16" else 4
    nbytes = n * 321 * 4 + dual_mlp_macs() * wbytes + n * 2 * 4
    return 2.0 * dual_mlp_macs() * n, float(nbytes)


def k1_tf32x3_work(n: int) -> Tuple[float, float]:
    """The float32 K1 as 3xTF32: three times its float32 operations."""
    flops, nbytes = k1_work(n, "float32")
    return 3.0 * flops, nbytes


def k2_tf32x3_work(n: int) -> Tuple[float, float]:
    """K2 (training forward) on n points as 3xTF32: xa, xb [n, 321]
    float32 and a mask [n] read, float32 weights, two float32 outputs."""
    nbytes = n * (2 * 321 * 4 + 4) + dual_mlp_macs() * 4 + n * 2 * 4
    return 3.0 * 2.0 * dual_mlp_macs() * n, float(nbytes)


def k3_work(ncol: int, z: int, dtype: str) -> Tuple[float, float]:
    """K3 over ncol columns of z depths: x_lr [ncol, 256], x_hr [ncol,
    64] float32 and zf [z] read, outputs [ncol, z] x 2 float32."""
    macs = ncol * (column_feature_macs() + z * hidden_chain_macs())
    wbytes = 2 if dtype == "bfloat16" else 4
    nbytes = (ncol * FEATURES * 4 + z * 4 + dual_mlp_macs() * wbytes
              + 2 * ncol * z * 4)
    return 2.0 * macs, float(nbytes)


def k3_tf32x3_work(ncol: int, z: int) -> Tuple[float, float]:
    flops, nbytes = k3_work(ncol, z, "float32")
    return 3.0 * flops, nbytes


def bound_s(flops: float, nbytes: float, peak: str) -> float:
    """Least seconds: the larger of operations over the peak and bytes
    over the memory rate."""
    return max(flops / PEAK_FLOPS[peak], nbytes / HBM_BYTES_PER_S)


def share_pct(least_s: float, took_s: float):
    """A roofline share in %, or None where nothing was timed."""
    if took_s <= 0.0 or least_s <= 0.0:
        return None
    return 100.0 * least_s / took_s


def union_s(intervals: Iterable[Tuple[float, float]]) -> float:
    """Seconds covered by the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def gaps(intervals: Iterable[Tuple[float, float]], start: float,
         stop: float) -> List[Tuple[float, float]]:
    """The idle (start, end) stretches of [start, stop] that no interval
    covers."""
    out, cur = [], start
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, stop)))
        cur = max(cur, b)
        if cur >= stop:
            break
    if cur < stop:
        out.append((cur, stop))
    return [(a, b) for a, b in out if b > a]
