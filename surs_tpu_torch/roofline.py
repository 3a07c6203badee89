"""Least times (roofline bounds) of the repository's five TPU kernels
(K1-K5), and of the port's winding-number kernel, on one NVIDIA H100
SXM, from their shapes alone.

A kernel's bound is the larger of two times: the bytes it must move
(each input read once, each output written once) over the card's
memory rate, and the operations it must do over the card's peak rate
for their type (NVIDIA's data sheet: dense bf16 989 TFLOP/s, dense TF32
495 TFLOP/s, float32 outside the tensor cores 67 TFLOP/s, HBM3 3.35
TB/s; at the 700 W limit). Operations are the real multiply-adds of the occupancy MLPs
(2 FLOP each), counted from the layer widths: K1 and K2 run both MLPs
per point; K3 and K4 run the feature products once per column (or
window) and only the hidden chain per depth sample; K5 only moves rows.
K2 is float32-accurate on the tensor cores by 3xTF32 (three TF32
products per float32 product): its bound counts the same multiply-adds
three times at the TF32 peak, beside the float32 FMA bound. The winding
number (``containment_work``) runs outside the tensor cores, at the
float32 peak.

    python -m surs_tpu_torch.roofline     # the table at main-path shapes

chip_smoke.py computes the bounds of the ported kernels with these
functions, at the shapes it runs them.
"""

from __future__ import annotations

import json
from typing import Dict, Sequence, Tuple

PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
DIMS_LR = (321, 1024, 512, 256, 128, 1)
DIMS_HR = (322, 1024, 512, 256, 128, 1)
RES_LAYERS = (2, 3, 4)
# the feature part of the MLP input: lr (hg_dim) + hr (64) channels;
# the depth feature and the coarse prediction are the other 1 + 1
FEATURES = 256 + 64


def bound(flops: float, nbytes: float, dtype: str) -> Tuple[float, str]:
    """(bound_ms, "operations" | "bytes")."""
    t_op = flops / PEAK_FLOPS[dtype] * 1e3
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_op, t_mem), "operations" if t_op >= t_mem else "bytes"


def _fan_ins(dims: Sequence[int]):
    return [dims[i] + (dims[0] if i in RES_LAYERS else 0)
            for i in range(len(dims) - 1)]


def dual_mlp_macs() -> int:
    """Multiply-adds of both MLPs for one point (input re-read by the
    residual layers)."""
    return sum(f * d for dims in (DIMS_LR, DIMS_HR)
               for f, d in zip(_fan_ins(dims), dims[1:]))


def hidden_chain_macs() -> int:
    """Per depth sample in K3/K4: the h-part of every layer past the
    first, both MLPs."""
    return sum(dims[i] * dims[i + 1] for dims in (DIMS_LR, DIMS_HR)
               for i in range(1, len(dims) - 1))


def column_feature_macs() -> int:
    """Per column (K3) or window (K4): the feature rows of every layer
    that reads the input (layer 0 and the residual layers), both MLPs."""
    return sum(FEATURES * dims[i + 1] for dims in (DIMS_LR, DIMS_HR)
               for i in range(len(dims) - 1) if i == 0 or i in RES_LAYERS)


def dual_mlp_work(n: int, dtype: str, input_bytes: int
                  ) -> Tuple[float, float]:
    """(flops, bytes) of K1/K2 for n points: ``input_bytes`` per point
    read once, the weights once in ``dtype`` (one weight per multiply-add
    of a point), two float32 outputs."""
    wbytes = 2 if dtype == "bfloat16" else 4
    nbytes = n * input_bytes + dual_mlp_macs() * wbytes + n * 2 * 4
    return 2.0 * dual_mlp_macs() * n, float(nbytes)


def k1_work(n: int, dtype: str):
    """K1: x [n, 321] float32."""
    return dual_mlp_work(n, dtype, 321 * 4)


def k2_work(n: int):
    """K2, float32 weights: xa, xb [n, 321] float32 and mask_a [n]."""
    return dual_mlp_work(n, "float32", 2 * 321 * 4 + 4)


def k2_tf32x3_work(n: int):
    """K2 in 3xTF32 (bound at the "tf32" peak): each float32 product is
    three TF32 products, so three times k2_work's operations; the same
    bytes (the function's inputs, weights and outputs, not the design's
    split operands)."""
    flops, nbytes = k2_work(n)
    return 3.0 * flops, nbytes


def k3_work(ncol: int, z: int, dtype: str = "bfloat16"):
    """K3: x_lr [ncol, 256], x_hr [ncol, 64] float32, zf [z]; outputs
    [ncol, z] x 2 float32."""
    macs = ncol * (column_feature_macs() + z * hidden_chain_macs())
    wbytes = 2 if dtype == "bfloat16" else 4
    nbytes = (ncol * FEATURES * 4 + z * 4 + dual_mlp_macs() * wbytes
              + 2 * ncol * z * 4)
    return 2.0 * macs, float(nbytes)


def k4_work(nr: int, zb: int, dtype: str = "bfloat16"):
    """K4: x_lr [nr, 256], x_hr [nr, 64] float32, kf [nr], zt [zb];
    outputs [nr, zb] x 2 float32."""
    macs = nr * (column_feature_macs() + zb * hidden_chain_macs())
    wbytes = 2 if dtype == "bfloat16" else 4
    nbytes = (nr * (FEATURES + 1) * 4 + zb * 4 + dual_mlp_macs() * wbytes
              + 2 * nr * zb * 4)
    return 2.0 * macs, float(nbytes)


def k5_work(rows: int, n_idx: int, channels: int, elem_bytes: int = 2):
    """K5: gather n_idx rows of feat [rows, channels] by int32 index:
    no arithmetic, feat and idx read once, the rows written once. The
    bound counts the map read once from device memory: a warm chain
    whose map and output stay in the 50 MB L2 can run below it, so the
    bound is compared only with a time taken with L2 cold."""
    nbytes = rows * channels * elem_bytes + n_idx * 4 \
        + n_idx * channels * elem_bytes
    return 0.0, float(nbytes)


# operations of one point-triangle pair of the winding number
# (csrc/winding_number.cu): 9 subtractions (a, b, c), 3 x 5 for the
# squared lengths, 3 square roots, 9 for b x c and 5 for a . (b x c),
# 3 x 5 for the dot products, 8 for the denominator, an arctangent, and
# 2 to double it and add it; each square root and arctangent counted as
# one operation, so the bound is a floor
CONTAINMENT_PAIR_OPS = 9 + 15 + 3 + 9 + 5 + 15 + 8 + 1 + 2
# the training sample draw: 4N surface points + N/4 uniform ones at
# N = 6,000 (data/sampling.py)
CONTAINMENT_POINTS = 4 * 6_000 + 6_000 // 4


def containment_work(points: int, faces: int):
    """The winding number of ``points`` query points against a mesh of
    ``faces`` triangles: CONTAINMENT_PAIR_OPS a pair; the points [P, 3]
    and the triangles [T, 3, 3] float32 read once, [P] float32
    written."""
    nbytes = points * 3 * 4 + faces * 9 * 4 + points * 4
    return float(CONTAINMENT_PAIR_OPS) * points * faces, float(nbytes)


# the shapes each kernel's main path gives it
MAIN_PATH = {
    "K1": ("fused_dual_mlp, 50,000 points per call, bf16 weights",
           lambda: k1_work(50_000, "bfloat16"), "bfloat16"),
    "K2": ("fused_dual_mlp_train, 12,000 points per call (batch 2 x "
           "6,000), float32 weights, 3xTF32 on the tensor cores",
           lambda: k2_tf32x3_work(12_000), "tf32"),
    "K2_fma": ("the same in float32 FMA outside the tensor cores",
               lambda: k2_work(12_000), "float32"),
    "K3": ("fused_dual_mlp_cols, one dense 512^3 grid: 262,144 columns "
           "x 512 depths, bf16 weights",
           lambda: k3_work(512 * 512, 512), "bfloat16"),
    "K4": ("fused_dual_mlp_runs, one chunk of 32,768 windows x 8 depths, "
           "bf16 weights", lambda: k4_work(32_768, 8), "bfloat16"),
    "K5": ("vmem_gather_probe, 49,152 rows of a [16384, 256] bf16 map",
           lambda: k5_work(16_384, 49_152, 256), "bfloat16"),
    "winding_number": ("containment of one training item's 25,500 "
                       "points against a 327,680-face HR mesh, float32",
                       lambda: containment_work(CONTAINMENT_POINTS,
                                                327_680), "float32"),
}


def table() -> Dict[str, Dict]:
    out = {}
    for name, (what, work, dtype) in MAIN_PATH.items():
        flops, nbytes = work()
        ms, by = bound(flops, nbytes, dtype)
        out[name] = {"shape": what, "gflop": flops / 1e9,
                     "mbytes": nbytes / 1e6, "bound_ms": ms, "bound_by": by}
    return out


if __name__ == "__main__":
    for name, row in table().items():
        print(json.dumps({"kernel": name, **row}))
