"""Kernels K1-K4: the fused dual occupancy MLP for serving, training,
dense columns and octree windows, each beside its plain version.

K1 is the counterpart of ``fused_dual_mlp`` in
``surs_tpu/ops/fused_mlp.py`` (Pallas body ``_kernel``). Per point: the
coarse MLP (dims_lr, input re-concatenated before ``res_layers``,
leaky-ReLU 0.01, sigmoid) gives pred_lr; the fine MLP runs on
[x, pred_lr] and gives pred_hr.

K2 is the counterpart of ``fused_dual_mlp_train`` (Pallas body
``_kernel_train``): the coarse MLP runs on ``xa``, the fine MLP on
[xb, mask_a * pred_lr]; both outputs unmasked. Its CUDA source is
``csrc/fused_train_tf32.cu``: float32-accurate 3xTF32 on the tensor cores,
one GEMM kernel launch per layer on operands split into TF32 hi and lo
parts (``tf32_split``) and tiled (``split_tiles``; the weights by a pack
kernel per call, ``pack_k2``), and a float32 head;
``fused_dual_mlp_train_tf32x3_ref`` composes the plain versions of its
kernels. Its autograd op
(``make_fused_dual_mlp_train_ad``) launches K2 forward and, like the JAX
custom_vjp, differentiates a recompute of the plain version backward.

K3 (``fused_dual_mlp_cols``, Pallas body ``_kernel_cols``) and K4
(``fused_dual_mlp_runs``, body ``_kernel_runs``) run the column-shared
chain of the TPU's ``_cols_chain``: every point of a grid column shares
its sampled features, so each input-reading layer takes a per-column
term once and a rank-1 depth term per sample; K3 expands one column over
Z depths, K4 one 8-deep window per row of ``x`` at its own depth offset
``kf``. Their CUDA source is ``csrc/fused_cols_mlp.cu``. Each runs as
two kernels per chunk of columns: a pre-pass writes the column terms
(``column_terms``), then the hidden chain runs on wgmma over weights that
``prepare_cols_weights`` repacks into ring stages. In bf16 the stages are
``hidden_stages`` in the layout of ``stage_index`` (``ColsPacked``); in
float32 the kernels are float32-accurate 3xTF32 as K2, every weight
split into TF32 hi and lo (``ColsPackedTF32``: ``tf32_stages`` in K2's
tile layout, k rows permuted by ``TF32_KPERM``), and
``fused_dual_mlp_cols_tf32x3_ref`` / ``fused_dual_mlp_runs_tf32x3_ref``
compose the plain versions of their arithmetic.

``prepare_fused_weights`` packs each MLP's weights into one flat buffer
in the compute dtype, each layer split into the row block that
multiplies the previous activation (``h``) and the row block that
multiplies the input (``x``, zero-padded to ``XK`` rows), and the biases
into one float32 buffer. The plain versions read these buffers. At the
kernel's widths it also repacks them for K1: in bf16 ``K1Packed`` (ring
stages in ``k1_stages`` order, in the wgmma layout of ``stage_index``,
and the float32 epilogue rows); in float32, for weights on the card,
the float32 K3/K4's ``ColsPackedTF32``, since the float32 K1 runs their
kernels with one point a row (the pre-pass with the depth column as
``kf``, then the chain; ``fused_dual_mlp_tf32x3_ref`` composes their
plain versions). The TPU layout (128-lane padding) is not carried over.

``fused_dual_mlp`` launches the kernel for CUDA tensors and takes the
plain version only for CPU tensors. The plain version rounds where the
TPU kernel rounds: the input, each activation and pred_lr are cast to
the compute dtype before their product; sums, bias, leaky-ReLU and
sigmoid are float32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

# widths the CUDA kernel is compiled for (csrc/fused_dual_mlp.cu)
KERNEL_DIMS_LR = (321, 1024, 512, 256, 128, 1)
KERNEL_DIMS_HR = (322, 1024, 512, 256, 128, 1)
KERNEL_RES_LAYERS = (2, 3, 4)


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


class MLPSpec(NamedTuple):
    dims: Tuple[int, ...]         # e.g. (321, 1024, 512, 256, 128, 1)
    res_layers: Tuple[int, ...]   # layers that re-read the input


class K1Packed(NamedTuple):
    """The bf16 K1's buffers (``prepare_fused_weights``), built from the
    packing below: every weight it puts on the tensor cores in ring
    stages, and the float32 rows its epilogues read."""
    stages: torch.Tensor  # [2, K1_STAGES, 8192] compute dtype (k1_stages)
    nbytes: torch.Tensor  # [K1_STAGES] int32: bytes of each stage
    vec: torch.Tensor     # [2, K1_VEC] float32, per MLP at K1_VEC_OFF


class FusedWeights(NamedTuple):
    w_lr: torch.Tensor    # packed weights, compute dtype
    b_lr: torch.Tensor    # packed biases, float32
    w_hr: torch.Tensor
    b_hr: torch.Tensor
    spec_lr: MLPSpec
    spec_hr: MLPSpec
    xk: int               # padded input width (dims_hr[0] rounded to 16)
    # at the kernel's widths: K1Packed in bf16; ColsPackedTF32 in float32
    # for weights on the card
    packed: Optional[Tuple] = None


def _layout(spec: MLPSpec, xk: int):
    """Per layer: (h block (offset, rows) or None, x block or None,
    bias offset, out width). Blocks follow each other in layer order,
    h before x; the x block has ``xk`` rows."""
    out, w_off, b_off = [], 0, 0
    dims = spec.dims
    for i in range(len(dims) - 1):
        n = dims[i + 1]
        hb = xb = None
        if i > 0:
            hb = (w_off, dims[i])
            w_off += dims[i] * n
        if i == 0 or i in spec.res_layers:
            xb = (w_off, xk)
            w_off += xk * n
        out.append((hb, xb, b_off, n))
        b_off += n
    return out


def mlp_params(mlp) -> List[torch.Tensor]:
    """A SurfaceClassifier's parameters in packing order:
    conv0.weight, conv0.bias, conv1.weight, ..."""
    out = []
    for i in range(len(mlp.dims) - 1):
        lin = getattr(mlp, f"conv{i}")
        out += [lin.weight, lin.bias]
    return out


def _pack(params: Sequence[torch.Tensor], spec: MLPSpec, xk: int, dtype):
    """Pack nn.Linear weights [out, in] and biases (``mlp_params``
    order) into the kernel's buffers. Differentiable: the packed buffers
    keep the graph back to ``params``."""
    ws, bs = [], []
    for i, (hb, xb, _, n) in enumerate(_layout(spec, xk)):
        w = params[2 * i].float().t()                    # [in, out]
        rows = 0
        if hb is not None:
            ws.append(w[:hb[1]].reshape(-1))
            rows = hb[1]
        if xb is not None:
            wx = w[rows:]
            pad = wx.new_zeros((xk - wx.shape[0], n))
            ws.append(torch.cat([wx, pad]).reshape(-1))
        bs.append(params[2 * i + 1].float())
    return torch.cat(ws).to(dtype).contiguous(), torch.cat(bs).contiguous()


def _specs(mlp_lr, mlp_hr) -> Tuple[MLPSpec, MLPSpec, int]:
    spec_lr = MLPSpec(mlp_lr.dims, mlp_lr.res_layers)
    spec_hr = MLPSpec(mlp_hr.dims, mlp_hr.res_layers)
    if spec_hr.dims[0] != spec_lr.dims[0] + 1:
        raise ValueError("dims_hr[0] must equal dims_lr[0] + 1")
    return spec_lr, spec_hr, _round16(spec_hr.dims[0])


def _pack_pair(params_lr, params_hr, specs, dtype) -> FusedWeights:
    spec_lr, spec_hr, xk = specs
    w_lr, b_lr = _pack(params_lr, spec_lr, xk, dtype)
    w_hr, b_hr = _pack(params_hr, spec_hr, xk, dtype)
    return FusedWeights(w_lr, b_lr, w_hr, b_hr, spec_lr, spec_hr, xk)


def prepare_fused_weights(mlp_lr, mlp_hr, dtype=torch.float32
                          ) -> FusedWeights:
    """Pack the two SurfaceClassifiers (models/surface_classifier.py)
    for K1 and K2, on their device, detached from autograd. dims_hr[0]
    must be dims_lr[0] + 1. At the kernel's widths, also K1's repacking:
    ``K1Packed`` in bf16; in float32 ``ColsPackedTF32``, built only for
    weights on the card (``_packs_f32_k1``): CPU tensors take the plain
    version, which does not read it."""
    fw = _pack_pair([p.detach() for p in mlp_params(mlp_lr)],
                    [p.detach() for p in mlp_params(mlp_hr)],
                    _specs(mlp_lr, mlp_hr), dtype)
    if _kernel_widths(fw):
        if dtype == torch.bfloat16:
            fw = fw._replace(packed=_pack_k1(fw))
        elif dtype == torch.float32 and _packs_f32_k1(fw.w_lr.device):
            fw = fw._replace(packed=_pack_cols(fw))
    return fw


def _packs_f32_k1(device) -> bool:
    """Whether prepare_fused_weights builds the float32 K1's packing for
    weights on ``device``: on the card only."""
    return device.type == "cuda"


# ------------------------------------------------------------------------
def _chain_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               spec: MLPSpec, xk: int) -> torch.Tensor:
    """x [N, xk] float32 holding compute-dtype values -> logit [N]."""
    cdt = w.dtype
    layout = _layout(spec, xk)
    h = None
    for i, (hb, xb, bo, n) in enumerate(layout):
        acc = b[bo:bo + n]
        if hb is not None:
            wh = w[hb[0]:hb[0] + hb[1] * n].view(hb[1], n).float()
            acc = acc + h.to(cdt).float() @ wh
        if xb is not None:
            wx = w[xb[0]:xb[0] + xk * n].view(xk, n).float()
            acc = acc + x @ wx
        h = acc if i == len(layout) - 1 else torch.where(acc >= 0, acc,
                                                         0.01 * acc)
    return h[:, 0]


def fused_dual_mlp_ref(parts: Sequence[torch.Tensor], fw: FusedWeights
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1 on the same packed weights:
    parts [N, w_i] float32 with sum(w_i) == dims_lr[0] ->
    (pred_hr [N], pred_lr [N]) float32."""
    cdt = fw.w_lr.dtype
    x = torch.cat([p.float() for p in parts], dim=-1)
    N, C = x.shape
    xp = x.new_zeros((N, fw.xk))
    xp[:, :C] = x.to(cdt).float()
    pred_lr = torch.sigmoid(_chain_ref(xp, fw.w_lr, fw.b_lr, fw.spec_lr,
                                       fw.xk))
    xp[:, C] = pred_lr.to(cdt).float()
    pred_hr = torch.sigmoid(_chain_ref(xp, fw.w_hr, fw.b_hr, fw.spec_hr,
                                       fw.xk))
    return pred_hr, pred_lr


def _check_kernel_inputs(inputs: List[torch.Tensor], fw: FusedWeights):
    if (fw.spec_lr.dims != KERNEL_DIMS_LR or fw.spec_hr.dims != KERNEL_DIMS_HR
            or fw.spec_lr.res_layers != KERNEL_RES_LAYERS
            or fw.spec_hr.res_layers != KERNEL_RES_LAYERS):
        raise ValueError(
            f"the CUDA kernel is built for dims {KERNEL_DIMS_LR} / "
            f"{KERNEL_DIMS_HR} with res layers {KERNEL_RES_LAYERS}; got "
            f"{fw.spec_lr} / {fw.spec_hr}")
    dev = inputs[0].device
    for t in inputs + [fw.w_lr, fw.b_lr, fw.w_hr, fw.b_hr]:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("the CUDA kernels need contiguous tensors on "
                             "one device")
    for p in inputs:
        if p.dtype != torch.float32:
            raise ValueError(f"kernel inputs must be float32, got {p.dtype}")
    if fw.w_lr.dtype not in (torch.bfloat16, torch.float32) \
            or fw.w_hr.dtype != fw.w_lr.dtype:
        raise ValueError(f"unsupported weight dtype {fw.w_lr.dtype}")


def _k1_parts(x, fw: FusedWeights) -> List[torch.Tensor]:
    """K1's input as a list of 2-D parts [N, w_i] making [N,
    dims_lr[0]]; raises otherwise."""
    parts = list(x) if isinstance(x, (list, tuple)) else [x]
    N = parts[0].shape[0]
    widths = [p.shape[1] for p in parts]
    if any(p.dim() != 2 or p.shape[0] != N for p in parts) \
            or sum(widths) != fw.spec_lr.dims[0]:
        raise ValueError(f"input parts {[tuple(p.shape) for p in parts]} "
                         f"do not make [N, {fw.spec_lr.dims[0]}]")
    return parts


def _k1_takes_plain(dev) -> bool:
    """True for CPU tensors, which take K1's plain version; False for
    CUDA tensors; anything else raises."""
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"K1 runs on CUDA or CPU tensors, not {dev}")
    return dev.type == "cpu"


def fused_dual_mlp(x, fw: FusedWeights) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both occupancy MLPs over point features.

    ``x``: [N, dims_lr[0]] float32, or a sequence of parts [N, w_i]
    (e.g. the (256, 65) split of lr features | hr features + depth).
    Returns (pred_hr [N], pred_lr [N]) float32 in [0, 1]. CUDA tensors
    launch kernel K1 (counted once per call in ``fused_dual_mlp.launches``):
    in bf16 the wgmma chain of ``csrc/fused_dual_mlp.cu``; in float32 the
    float32 K3/K4's pre-pass and chain with one point a row, per chunk of
    ``K1_CHUNK_POINTS`` points (:func:`fused_dual_mlp_tf32x3_ref` is their
    arithmetic); without ``prepare_fused_weights``' packing it raises. CPU
    tensors take :func:`fused_dual_mlp_ref`; anything else raises.
    """
    parts = _k1_parts(x, fw)
    N = parts[0].shape[0]
    widths = [p.shape[1] for p in parts]
    if _k1_takes_plain(parts[0].device):
        return fused_dual_mlp_ref(parts, fw)
    if len(parts) > 2:
        raise ValueError("K1 takes one or two input parts")
    _check_kernel_inputs(parts, fw)
    if fw.w_lr.dtype == torch.float32:
        return _k1_tf32x3(parts, fw)
    pk = fw.packed
    if not isinstance(pk, K1Packed):
        raise ValueError("the bf16 K1 takes prepare_fused_weights' "
                         "packing at the kernel's widths")
    x1 = parts[1] if len(parts) == 2 else None
    inputs = (parts[0].data_ptr(), widths[0],
              x1.data_ptr() if x1 is not None else None,
              widths[1] if x1 is not None else 0, N)
    return _launch(fused_dual_mlp, "fused_dual_mlp",
                   "surs_fused_dual_mlp_bf16", fw, (N,), inputs,
                   weights=(pk.stages, pk.nbytes, pk.vec))


fused_dual_mlp.launches = 0


# ------------------------------------------------------------------ K2 ---
def fused_dual_mlp_train_ref(xa: torch.Tensor, xb: torch.Tensor,
                             mask_a: torch.Tensor, fw: FusedWeights
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2 on the same packed weights, and the
    differentiable path of its backward: xa, xb [N, dims_lr[0]], mask_a
    [N] -> (pred_hr [N], pred_lr [N]) float32, unmasked."""
    cdt = fw.w_lr.dtype
    N, C = xa.shape

    def padded(x, cols):
        return torch.cat([x.float().to(cdt).float()] + cols
                         + [x.new_zeros((N, fw.xk - C - len(cols)))], 1)

    pred_lr = torch.sigmoid(_chain_ref(padded(xa, []), fw.w_lr, fw.b_lr,
                                       fw.spec_lr, fw.xk))
    cond = (pred_lr * mask_a.float()).to(cdt).float()
    pred_hr = torch.sigmoid(_chain_ref(padded(xb, [cond[:, None]]), fw.w_hr,
                                       fw.b_hr, fw.spec_hr, fw.xk))
    return pred_hr, pred_lr


# K2's CUDA kernels (csrc/fused_train_tf32.cu) take every operand split
# into TF32 hi and lo parts and tiled: tiles of [128 rows x 32 k] ordered
# [rows / 128][k / 32], each 128-byte row holding its 16-byte chunk c at
# chunk c ^ (row % 8) (the 128-byte swizzle wgmma reads, K-major).
K2_XK = 352                     # the input padded to a multiple of 32
# (N, K) of the packed W_i [out, in], layers 0-3: K = h width + K2_XK
# for the layers that read the input
K2_LAYERS = ((1024, K2_XK), (512, 1024), (256, 512 + K2_XK),
             (128, 256 + K2_XK))
K2_WBUF = sum(2 * n * k for n, k in K2_LAYERS)


def tf32_split(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 v -> (hi, lo): hi = tf32_rna(v), lo = tf32_rna(v - hi), with
    tf32_rna(v) = (bits(v) + 0x1000) & 0xFFFFE000, the round to nearest,
    ties away from zero, of ``cvt.rna.tf32.f32`` for a finite v; bit for
    bit what K2's kernels compute. |v - hi - lo| <= 2^-22 |v|."""
    def rna(t):
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)
    v = v.float()
    hi = rna(v)
    return hi, rna(v - hi)


@functools.lru_cache(maxsize=16)
def tile_index(rows: int, cols: int, device=None) -> torch.Tensor:
    """[rows * cols] int64: element p of the tile layout of a [rows, cols]
    operand (rows % 128 == 0, cols % 32 == 0) is element idx[p] of its
    row-major storage."""
    m = torch.arange(rows, device=device).view(rows // 128, 1, 128, 1, 1)
    kc = torch.arange(cols // 32, device=device).view(1, -1, 1, 1, 1)
    c = torch.arange(8, device=device).view(1, 1, 1, 8, 1)
    e = torch.arange(4, device=device).view(1, 1, 1, 1, 4)
    return (m * cols + kc * 32 + (c ^ (m % 8)) * 4 + e).reshape(-1)


def split_tiles(v: torch.Tensor) -> torch.Tensor:
    """[rows, cols] -> [2, rows * cols]: ``tf32_split`` of v, hi and lo
    each in the tile layout."""
    hi, lo = tf32_split(v)
    idx = tile_index(*v.shape, v.device)
    return torch.stack([hi.reshape(-1)[idx], lo.reshape(-1)[idx]])


def unsplit_tiles(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Inverse of the tiling of :func:`split_tiles`: [2, rows * cols] ->
    [2, rows, cols] (hi, lo)."""
    out = torch.empty_like(t)
    out[:, tile_index(rows, cols, t.device)] = t
    return out.view(2, rows, cols)


def _k2_mats(w: torch.Tensor, b: torch.Tensor, spec: MLPSpec, xk: int):
    """One MLP of K1's packing as K2 takes it: per layer (W [out, h width
    + K2_XK] float32, nn.Linear's layout with the input block zero-padded
    to K2_XK, bias)."""
    mats = []
    for hb, xb, bo, n in _layout(spec, xk):
        blocks = []
        if hb is not None:
            blocks.append(w[hb[0]:hb[0] + hb[1] * n].view(hb[1], n))
        if xb is not None:
            blocks += [w[xb[0]:xb[0] + xk * n].view(xk, n),
                       w.new_zeros((K2_XK - xk, n))]
        mats.append((torch.cat(blocks).t().float(), b[bo:bo + n]))
    return mats


def pack_k2_ref(fw: FusedWeights) -> torch.Tensor:
    """Plain version of K2's pack kernel: float32 FusedWeights at the
    kernel's widths -> [2, K2_WBUF], per MLP (lr, hr) and layer 0-3 the
    hi tiles then the lo tiles of W [N, K] (``K2_LAYERS``,
    :func:`split_tiles`). The last layer and the biases stay in ``fw``."""
    return torch.stack([
        torch.cat([split_tiles(wt).reshape(-1)
                   for wt, _ in _k2_mats(w, b, spec, fw.xk)[:4]])
        for w, b, spec in ((fw.w_lr, fw.b_lr, fw.spec_lr),
                           (fw.w_hr, fw.b_hr, fw.spec_hr))])


def pack_k2(fw: FusedWeights) -> torch.Tensor:
    """K2's weight tiles alone (:func:`pack_k2_ref`'s function). CUDA
    tensors launch K2's pack kernel (counted in ``pack_k2.launches``);
    CPU tensors take :func:`pack_k2_ref`. K2 packs inside its own call;
    this entry checks the pack kernel."""
    if fw.w_lr.device.type == "cpu":
        return pack_k2_ref(fw)
    _check_kernel_inputs([fw.w_lr], fw)
    wt = torch.empty((2, K2_WBUF), dtype=torch.float32, device=fw.w_lr.device)
    lib = _kernel_lib("fused_train_tf32")
    with torch.cuda.device(wt.device):
        rc = lib.surs_k2_pack_weights(
            fw.w_lr.data_ptr(), fw.w_hr.data_ptr(), wt.data_ptr(),
            torch.cuda.current_stream(wt.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("pack_k2 launch failed: "
                           + lib.surs_cuda_error_string(rc).decode())
    pack_k2.launches += 1
    return wt


pack_k2.launches = 0


def tf32x3_linear_ref(a_hi, a_lo, w_hi, w_lo, b) -> torch.Tensor:
    """Plain version of K2's GEMM kernel on split operands, float32:
    leaky(a_lo . w_hi^T + a_hi . w_lo^T + a_hi . w_hi^T + b), a [M, K],
    w [N, K] -> [M, N]."""
    acc = a_lo @ w_hi.t() + a_hi @ w_lo.t() + a_hi @ w_hi.t() + b
    return torch.where(acc >= 0, acc, 0.01 * acc)


def k2_head_ref(h3: torch.Tensor, x: torch.Tensor, w4: torch.Tensor,
                b4: torch.Tensor) -> torch.Tensor:
    """Plain version of K2's head kernel: sigmoid(h3 . w4h + x . w4x +
    b4), h3 [M, 128], x [M, K2_XK] float32, w4 [1, 128 + K2_XK] -> [M]."""
    d3 = h3.shape[1]
    return torch.sigmoid(h3 @ w4[0, :d3] + x @ w4[0, d3:] + b4)


def _k2_mlp_ref(x: torch.Tensor, mats) -> torch.Tensor:
    xs = tf32_split(x)
    h = None
    for i, (wt, b) in enumerate(mats[:4]):
        if i == 0:
            a = xs
        elif i == 1:
            a = h
        else:
            a = tuple(torch.cat([hp, xp], 1) for hp, xp in zip(h, xs))
        h = tf32_split(tf32x3_linear_ref(*a, *tf32_split(wt), b))
    return k2_head_ref(h[0] + h[1], x, *mats[4])


def fused_dual_mlp_train_tf32x3_ref(xa: torch.Tensor, xb: torch.Tensor,
                                    mask_a: torch.Tensor, fw: FusedWeights
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's arithmetic from the plain versions of its kernels: the split,
    four 3xTF32 layers (each output split again), the head, per MLP; the
    fine MLP's input column C the coarse prediction times ``mask_a``.
    Float32 FusedWeights -> (pred_hr [N], pred_lr [N])."""
    N, C = xa.shape

    def padded(x, cols):
        return torch.cat([x.float()] + cols
                         + [x.new_zeros((N, K2_XK - C - len(cols)))], 1)

    pred_lr = _k2_mlp_ref(padded(xa, []), _k2_mats(fw.w_lr, fw.b_lr,
                                                   fw.spec_lr, fw.xk))
    cond = pred_lr * mask_a.float()
    pred_hr = _k2_mlp_ref(padded(xb, [cond[:, None]]),
                          _k2_mats(fw.w_hr, fw.b_hr, fw.spec_hr, fw.xk))
    return pred_hr, pred_lr


def k2_scratch_floats(n: int) -> int:
    """Floats of K2's scratch for n points: xa's and xb's tiles and
    layers 0-3's outputs, each hi and lo, over n rounded up to 128."""
    mp = -(-n // 128) * 128
    return mp * 2 * (2 * K2_XK + sum(n_out for n_out, _ in K2_LAYERS))


def fused_dual_mlp_train(xa: torch.Tensor, xb: torch.Tensor,
                         mask_a: torch.Tensor, fw: FusedWeights
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train-time dual chain: coarse MLP on ``xa`` [N, dims_lr[0]], fine
    MLP on ``xb`` [N, dims_lr[0]] + (``mask_a`` [N] * coarse prediction).
    Returns (pred_hr [N], pred_lr [N]) float32, both unmasked. CUDA
    tensors launch kernel K2 (float32 weights, tiled per call by its pack
    kernel; its 12 kernel launches counted once in
    ``fused_dual_mlp_train.launches``); CPU tensors take
    :func:`fused_dual_mlp_train_ref`; anything else raises."""
    C = fw.spec_lr.dims[0]
    N = xa.shape[0]
    if xa.dim() != 2 or xa.shape != xb.shape or xa.shape[1] != C \
            or mask_a.shape != (N,):
        raise ValueError(f"xa {tuple(xa.shape)}, xb {tuple(xb.shape)}, "
                         f"mask_a {tuple(mask_a.shape)} do not make "
                         f"[N, {C}], [N, {C}], [N]")
    dev = xa.device
    if dev.type == "cpu":
        return fused_dual_mlp_train_ref(xa, xb, mask_a, fw)
    if dev.type != "cuda":
        raise ValueError(f"K2 runs on CUDA or CPU tensors, not {dev}")
    mask_a = mask_a.to(torch.float32).contiguous()
    _check_kernel_inputs([xa, xb, mask_a], fw)
    if fw.w_lr.dtype != torch.float32:
        raise ValueError("K2 is built for float32 weights, got "
                         f"{fw.w_lr.dtype}")
    wt = torch.empty((2, K2_WBUF), dtype=torch.float32, device=dev)
    scratch = torch.empty(k2_scratch_floats(N), dtype=torch.float32,
                          device=dev)
    return _launch(fused_dual_mlp_train, "fused_train_tf32",
                   "surs_fused_dual_mlp_train_tf32x3", fw, (N,),
                   (xa.data_ptr(), xb.data_ptr(), mask_a.data_ptr(), C, N),
                   weights=(fw.w_lr, fw.b_lr, fw.w_hr, fw.b_hr, wt, scratch))


fused_dual_mlp_train.launches = 0


def tf32x3_linear(a1: torch.Tensor, a2: Optional[torch.Tensor],
                  w: torch.Tensor, bias: torch.Tensor, rows: int
                  ) -> torch.Tensor:
    """One layer of K2 alone: a1 [2, rows * K1] and a2 [2, rows * K2] (or
    None) the hi / lo tiles of A = [a1 | a2] (:func:`split_tiles`), w
    [2, N * (K1 + K2)] W's tiles, bias [N] float32 -> [2, rows * N], the
    tiles of split(leaky(A . W^T + bias)). rows % 128 == 0. CUDA tensors
    launch K2's GEMM kernel (counted in ``tf32x3_linear.launches``); CPU
    tensors take :func:`tf32x3_linear_ref`."""
    n_out = bias.shape[0]
    k1 = a1.shape[1] // rows
    k2 = 0 if a2 is None else a2.shape[1] // rows
    ins = [a1, w, bias] + ([] if a2 is None else [a2])
    if rows % 128 or n_out % 128 or k1 % 32 or k2 % 32 \
            or w.shape != (2, n_out * (k1 + k2)) \
            or any(t.dtype != torch.float32 or not t.is_contiguous()
                   or t.device != a1.device for t in ins):
        raise ValueError("tf32x3_linear takes contiguous float32 tiles on "
                         "one device: rows and N multiples of 128, K of 32")
    if a1.device.type == "cpu":
        parts = [unsplit_tiles(a1, rows, k1)]
        if a2 is not None:
            parts.append(unsplit_tiles(a2, rows, k2))
        a = torch.cat(parts, 2)
        wt = unsplit_tiles(w, n_out, k1 + k2)
        return split_tiles(tf32x3_linear_ref(a[0], a[1], wt[0], wt[1],
                                             bias))
    out = torch.empty((2, rows * n_out), dtype=torch.float32,
                      device=a1.device)
    lib = _kernel_lib("fused_train_tf32")
    with torch.cuda.device(a1.device):
        rc = lib.surs_tf32x3_gemm(
            a1[0].data_ptr(), a1[1].data_ptr(), k1 // 32,
            None if a2 is None else a2[0].data_ptr(),
            None if a2 is None else a2[1].data_ptr(), k2 // 32,
            w[0].data_ptr(), w[1].data_ptr(), bias.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), rows // 128, n_out,
            torch.cuda.current_stream(a1.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("tf32x3_linear launch failed: "
                           + lib.surs_cuda_error_string(rc).decode())
    tf32x3_linear.launches += 1
    return out


tf32x3_linear.launches = 0


def _train_weights(params, specs) -> FusedWeights:
    """Float32 packing of ``mlp_params(mlp_lr) + mlp_params(mlp_hr)``;
    keeps the graph back to ``params``."""
    n = 2 * (len(specs[0].dims) - 1)
    return _pack_pair(params[:n], params[n:], specs, torch.float32)


class _FusedDualMLPTrain(torch.autograd.Function):
    """K2 forward; backward through a recompute of the plain version, as
    the JAX custom_vjp (``surs_tpu/ops/fused_mlp.py:378-412``) recomputes
    its XLA twin. No gradient for the mask."""

    @staticmethod
    def forward(ctx, xa, xb, mask_a, specs, *params):
        ctx.specs = specs
        ctx.save_for_backward(xa, xb, mask_a, *params)
        return fused_dual_mlp_train(xa, xb, mask_a,
                                    _train_weights(params, specs))

    @staticmethod
    def backward(ctx, g_hr, g_lr):
        xa, xb, mask_a, *params = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in (xa, xb, *params)]
            outs = fused_dual_mlp_train_ref(
                ins[0], ins[1], mask_a, _train_weights(ins[2:], ctx.specs))
            grads = torch.autograd.grad(outs, ins, (g_hr, g_lr))
        return (grads[0], grads[1], None, None) + tuple(grads[2:])


def make_fused_dual_mlp_train_ad():
    """The train op ``op(xa, xb, mask_a, mlp_lr, mlp_hr) -> (pred_hr,
    pred_lr)``: K2 (its plain version for CPU tensors) forward, gradients
    to ``xa``, ``xb`` and every ``conv{i}`` weight and bias of the two
    SurfaceClassifiers."""
    def op(xa, xb, mask_a, mlp_lr, mlp_hr):
        return _FusedDualMLPTrain.apply(xa, xb, mask_a,
                                        _specs(mlp_lr, mlp_hr),
                                        *mlp_params(mlp_lr),
                                        *mlp_params(mlp_hr))
    return op


# ----------------------------------------------------------- K3 and K4 ---
# The bf16 K3/K4 (csrc/fused_cols_mlp.cu) run in two kernels per chunk of
# columns: a pre-pass that writes the column terms of every layer that
# reads the input, and the hidden chain on wgmma.
#
# Column terms, float32, per column (or window): for each MLP (lr, hr) the
# outputs of layers 0, 2, 3 and 4 at these offsets, then 3 pads.
FEAT = 320                      # feature rows of the input (lr + hr)
TERM_LAYERS = ((0, 0), (2, 1024), (3, 1280), (4, 1408))   # (layer, offset)
TERMS_MLP = 1412
TERMS_COLS = 2 * TERMS_MLP
TERMS_ROWS = 2880               # rows of the packed W_feat: TERMS_COLS up to 64
TERMS_BLOCK = 128               # columns per pre-pass block (buffer row pad)
# columns (K3) or windows (K4) per pre-pass / chain launch pair: bounds
# the column-term buffer at 32,768 x 2,824 x 4 bytes = 370 MB
CHUNK_COLS = 32768
# a ring stage of the hidden weights: 64 k x 128 n
STAGE_K, STAGE_N = 64, 128


class ColsPacked(NamedTuple):
    """The bf16 K3/K4's buffers, built from K1's packing."""
    wfeat: torch.Tensor   # [TERMS_ROWS, FEAT] W_feat transposed, compute dtype
    cvec: torch.Tensor    # [3, TERMS_COLS] float32: depth rows, prediction
                          # rows, biases, in the column-term layout
    hvec: torch.Tensor    # [2, 640] float32 per MLP: b1 | w4h
    whid: torch.Tensor    # [2, 84, 8192] W1h, W2h, W3h in ring stages


class ColsPackedTF32(NamedTuple):
    """The float32 (3xTF32) K3/K4's buffers, built from K1's packing:
    every weight on the tensor cores split by ``tf32_split``."""
    wfeat: torch.Tensor   # [2, TERMS_ROWS, FEAT] float32: hi, lo of W_feat^T
    cvec: torch.Tensor    # [3, TERMS_COLS] float32, as ColsPacked's
    hvec: torch.Tensor    # [2, 640] float32, as ColsPacked's
    whid: torch.Tensor    # [2, 168, 8192] float32: per MLP the tf32_stages,
                          # each hi [128 n x 32 k] then lo, K2's tile layout


class ColsWeights(NamedTuple):
    """Weights of the column kernels: K1's packing, whose x block already
    holds every row they read (features, then the depth row, then the
    coarse-prediction row), the (C_lr, C_hr) feature split, and the
    kernels' repacking at the kernel's widths (None otherwise):
    ``ColsPacked`` in bf16, ``ColsPackedTF32`` in float32."""
    fw: FusedWeights
    split: Tuple[int, int]
    packed: Optional[Tuple] = None


def hidden_stages() -> List[Tuple[int, int, int]]:
    """(layer, k0, n0) of the 84 ring stages of one MLP's hidden weights,
    in the order the bf16 K3/K4 consume them: layer 1 in two halves of 256
    outputs, each 16 k-chunks of 64 x two 128-wide blocks; layer 2, 8
    k-chunks x 2; layer 3, 4 k-chunks."""
    d = KERNEL_DIMS_LR
    out = []
    for half in range(d[2] // 256):
        for kc in range(d[1] // STAGE_K):
            for q in range(256 // STAGE_N):
                out.append((1, kc * STAGE_K, half * 256 + q * STAGE_N))
    for kc in range(d[2] // STAGE_K):
        for q in range(d[3] // STAGE_N):
            out.append((2, kc * STAGE_K, q * STAGE_N))
    for kc in range(d[3] // STAGE_K):
        out.append((3, kc * STAGE_K, 0))
    return out


def stage_index(device=None, kw: int = STAGE_K, nw: int = STAGE_N
                ) -> torch.Tensor:
    """[kw, nw] int64: where element (k, n) of a stage's [kw k, nw n]
    block of W [in, out] sits among the stage's elements. K-major with
    the 128-byte swizzle, as the wgmma descriptor reads it: each 64-k
    chunk is nw rows (one per output n) of 64 k (128 bytes), 8 rows make
    a 1,024-byte atom, and 16-byte piece (k % 64) // 8 of row n sits at
    piece ((k % 64) // 8) ^ (n % 8): (k // 64) * nw * 64 + n * 64 +
    (((k % 64) // 8) ^ (n % 8)) * 8 + k % 8."""
    k = torch.arange(kw, device=device)[:, None]
    n = torch.arange(nw, device=device)[None, :]
    return ((k // 64) * nw * 64 + n * 64 + (((k % 64) // 8) ^ (n % 8)) * 8
            + k % 8)


def _pack_stages(blocks, plan, like: torch.Tensor) -> torch.Tensor:
    """``plan`` [(block key, k0, n0, kw, nw)] -> [len(plan), 8192]: stage
    s holds blocks[key][k0:k0 + kw, n0:n0 + nw] at stage_index(kw, nw),
    zeros past its kw * nw elements."""
    stages = like.new_zeros((len(plan), STAGE_K * STAGE_N))
    for s, (key, k0, n0, kw, nw) in enumerate(plan):
        idx = stage_index(like.device, kw, nw).reshape(-1)
        stages[s, idx] = blocks[key][k0:k0 + kw, n0:n0 + nw].reshape(-1)
    return stages


def unpack_stages(stages: torch.Tensor, plan, shapes):
    """Inverse of :func:`_pack_stages`: {key: [in, out]} blocks of
    ``shapes`` from the stages; elements no stage covers stay NaN."""
    blocks = {key: stages.new_full(shape, float("nan"))
              for key, shape in shapes.items()}
    for s, (key, k0, n0, kw, nw) in enumerate(plan):
        idx = stage_index(stages.device, kw, nw)
        blocks[key][k0:k0 + kw, n0:n0 + nw] = stages[s][idx]
    return blocks


def _hidden_plan():
    return [(layer, k0, n0, STAGE_K, STAGE_N)
            for layer, k0, n0 in hidden_stages()]


def _hidden_blocks(w: torch.Tensor, spec: MLPSpec, xk: int):
    """{1: W1h, 2: W2h, 3: W3h} [in, out]: views of K1's packing."""
    blocks = {}
    for i in (1, 2, 3):
        (off, rows), _, _, n = _layout(spec, xk)[i]
        blocks[i] = w[off:off + rows * n].view(rows, n)
    return blocks


def _pack_hidden(w: torch.Tensor, spec: MLPSpec, xk: int) -> torch.Tensor:
    """One MLP's W1h, W2h, W3h as [84, 8192] ring stages."""
    return _pack_stages(_hidden_blocks(w, spec, xk), _hidden_plan(), w)


def unpack_hidden(stages: torch.Tensor):
    """Inverse of the stage packing: {1: W1h, 2: W2h, 3: W3h} [in, out]
    from one MLP's [84, 8192] stages."""
    d = KERNEL_DIMS_LR
    return unpack_stages(stages, _hidden_plan(),
                         {i: (d[i], d[i + 1]) for i in (1, 2, 3)})


# The float32 K3/K4 (3xTF32) stream each MLP's W1h, W2h, W3h as stages of
# [32 k x 128 n], hi then lo, each in K2's tile layout of the [128 n x 32 k]
# block (``tile_index``). Its A operands come from wgmma accumulators in
# registers, which hold columns 2t and 2t + 1 of each 8 where tf32's A
# fragment takes k t and t + 4: within every 8 k rows, stage row k holds
# weight row TF32_KPERM[k].
TF32_STAGE_K = 32
TF32_N1 = 128                   # layer-1 outputs per chunk (feeding layer 2)
TF32_KPERM = (0, 2, 4, 6, 1, 3, 5, 7)
TF32_STAGE = 2 * TF32_STAGE_K * STAGE_N     # floats: hi, then lo


def tf32_stages() -> List[Tuple[int, int, int]]:
    """(layer, k0, n0) of the 168 stages of one MLP's hidden weights in
    the order the float32 K3/K4 consume them: per 128-output chunk c of
    layer 1 its 32 k-stages, then layer 2's stages over those 128 k (k0 =
    128 c + 32 kk) for each half of its 256 outputs; then layer 3's 8."""
    d = KERNEL_DIMS_LR
    out = []
    for c in range(d[2] // TF32_N1):
        out += [(1, k0, c * TF32_N1) for k0 in range(0, d[1], TF32_STAGE_K)]
        out += [(2, c * TF32_N1 + k0, n0) for n0 in range(0, d[3], STAGE_N)
                for k0 in range(0, TF32_N1, TF32_STAGE_K)]
    out += [(3, k0, 0) for k0 in range(0, d[3], TF32_STAGE_K)]
    return out


def _tf32_rows(k0: int, device=None) -> torch.Tensor:
    """The weight rows of a stage's 32 k rows (``TF32_KPERM``)."""
    k = torch.arange(TF32_STAGE_K, device=device)
    perm = torch.tensor(TF32_KPERM, device=device)
    return k0 + 8 * (k // 8) + perm[k % 8]


def _pack_hidden_tf32(w: torch.Tensor, spec: MLPSpec, xk: int
                      ) -> torch.Tensor:
    """One float32 MLP's W1h, W2h, W3h as [168, TF32_STAGE] stages."""
    split = {i: tf32_split(b)
             for i, b in _hidden_blocks(w, spec, xk).items()}
    idx = tile_index(STAGE_N, TF32_STAGE_K, w.device)
    return torch.stack([
        torch.cat([part[_tf32_rows(k0, w.device), n0:n0 + STAGE_N].t()
                   .reshape(-1)[idx] for part in split[layer]])
        for layer, k0, n0 in tf32_stages()])


def unpack_hidden_tf32(stages: torch.Tensor):
    """Inverse of the float32 stage packing: {1: W1h, 2: W2h, 3: W3h},
    each [2, in, out] (hi, lo), from one MLP's [168, TF32_STAGE] stages;
    elements no stage covers stay NaN."""
    d = KERNEL_DIMS_LR
    out = {i: stages.new_full((2, d[i], d[i + 1]), float("nan"))
           for i in (1, 2, 3)}
    idx = tile_index(STAGE_N, TF32_STAGE_K, stages.device)
    for s, (layer, k0, n0) in enumerate(tf32_stages()):
        rows = _tf32_rows(k0, stages.device)
        for h, part in enumerate(stages[s].view(2, -1)):
            block = torch.empty_like(part)
            block[idx] = part
            out[layer][h, rows, n0:n0 + STAGE_N] = block.view(
                STAGE_N, TF32_STAGE_K).t()
    return out


# ---------------------------------------------------------- bf16 K1 -----
# The bf16 K1 (csrc/fused_dual_mlp.cu) streams every weight it puts on
# the tensor cores through one ring of 16 KB stages: the feature rows
# (the first FEAT input columns) of W0x, W2x and W3x, and the hidden
# blocks. The depth and coarse-prediction columns of the input (FEAT and
# FEAT + 1) enter its epilogues as float32 rank-1 terms, from ``vec``.
K1_BLOCKS = {"0x": (0, "x"), "1h": (1, "h"), "2h": (2, "h"), "2x": (2, "x"),
             "3h": (3, "h"), "3x": (3, "x")}
# per MLP, float32: offsets of the epilogue rows in ``K1Packed.vec``
# (csrc/fused_dual_mlp.cu: V_*); z = depth row, p = prediction row of the
# layer's x block; "tail" = [b4, w4 depth, w4 prediction, 0]
K1_VEC_OFF = {"b0": 0, "z0": 1024, "p0": 2048, "b1": 3072, "b2": 3584,
              "z2": 3840, "p2": 4096, "b3": 4352, "z3": 4480, "p3": 4608,
              "w4h": 4736, "w4x": 4864, "tail": 5184}
K1_VEC = 5188


def k1_stages() -> List[Tuple[str, int, int, int, int]]:
    """(block, k0, n0, kw, nw) of the bf16 K1's ring stages of one MLP,
    in the order its consumers take them. Layers 0 and 1 in two halves
    of 256 outputs; per 64-wide k-slice kc of layer 1, layer 0's slice
    from a W0x slice ([320 k x 64 n]: stages of 128, 128 and 64 k), then
    W1h's two [64 k x 128 n] stages of kc. Then layer 2 (W2h, 8 k-chunks
    x 2; W2x, 5 x 2) and layer 3 (W3h, 4; W3x, 5)."""
    d = KERNEL_DIMS_LR
    out = []
    for half in range(d[2] // 256):
        for kc in range(d[1] // STAGE_K):
            out += [("0x", k0, kc * STAGE_K, min(128, FEAT - k0), STAGE_K)
                    for k0 in range(0, FEAT, 128)]
            out += [("1h", kc * STAGE_K, half * 256 + q * STAGE_N, STAGE_K,
                     STAGE_N) for q in range(256 // STAGE_N)]
    for key, rows, n in (("2h", d[2], d[3]), ("2x", FEAT, d[3]),
                         ("3h", d[3], d[4]), ("3x", FEAT, d[4])):
        out += [(key, k0, n0, STAGE_K, STAGE_N)
                for k0 in range(0, rows, STAGE_K)
                for n0 in range(0, n, STAGE_N)]
    return out


K1_STAGES = 195


def k1_blocks(w: torch.Tensor, spec: MLPSpec, xk: int):
    """{key: [in, out]} of K1_BLOCKS: views of K1's packing, the x
    blocks cut to their FEAT feature rows."""
    layout = _layout(spec, xk)
    out = {}
    for key, (i, part) in K1_BLOCKS.items():
        hb, xb, _, n = layout[i]
        off, rows = hb if part == "h" else (xb[0], FEAT)
        out[key] = w[off:off + rows * n].view(rows, n)
    return out


def _pack_k1_vec(w, b, spec: MLPSpec, xk: int) -> torch.Tensor:
    layout = _layout(spec, xk)
    v = torch.zeros(K1_VEC, dtype=torch.float32, device=w.device)
    o = K1_VEC_OFF

    def xrows(i):
        _, xb, bo, n = layout[i]
        return w[xb[0]:xb[0] + xk * n].view(xk, n).float(), b[bo:bo + n]

    for i in (0, 2, 3):
        wx, bias = xrows(i)
        n = bias.shape[0]
        v[o[f"b{i}"]:o[f"b{i}"] + n] = bias
        v[o[f"z{i}"]:o[f"z{i}"] + n] = wx[FEAT]
        v[o[f"p{i}"]:o[f"p{i}"] + n] = wx[FEAT + 1]
    _, _, bo1, n1 = layout[1]
    v[o["b1"]:o["b1"] + n1] = b[bo1:bo1 + n1]
    h4 = layout[4][0]
    v[o["w4h"]:o["w4h"] + h4[1]] = w[h4[0]:h4[0] + h4[1]].float()
    wx, b4 = xrows(4)
    v[o["w4x"]:o["w4x"] + FEAT] = wx[:FEAT, 0]
    v[o["tail"]:o["tail"] + 3] = torch.stack([b4[0], wx[FEAT, 0],
                                              wx[FEAT + 1, 0]])
    return v


def _pack_k1(fw: FusedWeights) -> K1Packed:
    plan = k1_stages()
    nbytes = torch.tensor([kw * nw * fw.w_lr.element_size()
                           for _, _, _, kw, nw in plan], dtype=torch.int32,
                          device=fw.w_lr.device)
    mlps = ((fw.w_lr, fw.b_lr, fw.spec_lr), (fw.w_hr, fw.b_hr, fw.spec_hr))
    return K1Packed(
        torch.stack([_pack_stages(k1_blocks(w, spec, fw.xk), plan, w)
                     for w, _, spec in mlps]).contiguous(),
        nbytes,
        torch.stack([_pack_k1_vec(w, b, spec, fw.xk)
                     for w, b, spec in mlps]).contiguous())


def _pack_terms(w, b, spec: MLPSpec, xk: int):
    """One MLP's W_feat [TERMS_MLP, FEAT] (term-major), its depth,
    prediction and bias rows [3, TERMS_MLP] and its b1 | w4h [640]."""
    layout = _layout(spec, xk)
    wf = w.new_zeros((TERMS_MLP, FEAT))
    cv = torch.zeros((3, TERMS_MLP), dtype=torch.float32, device=w.device)
    for i, off in TERM_LAYERS:
        _, xb, bo, n = layout[i]
        wx = w[xb[0]:xb[0] + xk * n].view(xk, n)
        wf[off:off + n] = wx[:FEAT].t()
        cv[0, off:off + n] = wx[FEAT].float()
        cv[1, off:off + n] = wx[FEAT + 1].float()
        cv[2, off:off + n] = b[bo:bo + n]
    h4 = layout[4][0]
    _, _, bo1, n1 = layout[1]
    hv = torch.cat([b[bo1:bo1 + n1], w[h4[0]:h4[0] + h4[1]].float()])
    return wf, cv, hv


def _pack_cols(fw: FusedWeights):
    """ColsPacked (bf16) or ColsPackedTF32 (float32) of ``fw``."""
    lr = _pack_terms(fw.w_lr, fw.b_lr, fw.spec_lr, fw.xk)
    hr = _pack_terms(fw.w_hr, fw.b_hr, fw.spec_hr, fw.xk)
    wfeat = torch.cat([lr[0], hr[0], lr[0].new_zeros(
        (TERMS_ROWS - TERMS_COLS, FEAT))])
    vecs = (torch.cat([lr[1], hr[1]], 1).contiguous(),
            torch.stack([lr[2], hr[2]]).contiguous())
    mlps = ((fw.w_lr, fw.spec_lr), (fw.w_hr, fw.spec_hr))
    if fw.w_lr.dtype == torch.float32:
        return ColsPackedTF32(
            torch.stack(tf32_split(wfeat)).contiguous(), *vecs,
            torch.stack([_pack_hidden_tf32(w, spec, fw.xk)
                         for w, spec in mlps]).contiguous())
    return ColsPacked(
        wfeat.contiguous(), *vecs,
        torch.stack([_pack_hidden(w, spec, fw.xk)
                     for w, spec in mlps]).contiguous())


def _kernel_widths(fw: FusedWeights) -> bool:
    return (fw.spec_lr.dims == KERNEL_DIMS_LR
            and fw.spec_hr.dims == KERNEL_DIMS_HR
            and fw.spec_lr.res_layers == KERNEL_RES_LAYERS
            and fw.spec_hr.res_layers == KERNEL_RES_LAYERS)


def prepare_cols_weights(mlp_lr, mlp_hr, hg_dim: int = 256,
                         dtype=torch.float32,
                         fw: Optional[FusedWeights] = None) -> ColsWeights:
    """K3/K4 weights (``surs_tpu/ops/fused_mlp.py:prepare_cols_weights``):
    lr features (``hg_dim``) | hr features | depth, in K1's packing (the
    TPU's ``base_split`` only gave each segment its own 128-lane block),
    and, at the kernel's widths, the kernels' repacking of the same
    weights: ``ColsPacked`` in bf16, ``ColsPackedTF32`` in float32 (the
    float32 K1's own packing where ``prepare_fused_weights`` built it, not
    a second one). ``fw``: K1's weights of the same MLPs in ``dtype``,
    to share rather than pack again."""
    if fw is None:
        fw = prepare_fused_weights(mlp_lr, mlp_hr, dtype)
    elif fw.w_lr.dtype != dtype:
        raise ValueError(f"fw is packed in {fw.w_lr.dtype}, not {dtype}")
    c_hr = fw.spec_lr.dims[0] - 1 - hg_dim
    if hg_dim <= 0 or c_hr <= 0:
        raise ValueError(f"hg_dim {hg_dim} leaves no hr features in an "
                         f"input of {fw.spec_lr.dims[0]}")
    packed = None
    if _kernel_widths(fw):
        packed = (fw.packed if isinstance(fw.packed, ColsPackedTF32)
                  else _pack_cols(fw))
    return ColsWeights(fw, (hg_dim, c_hr), packed)


def _fw_of(w) -> FusedWeights:
    return w.fw if isinstance(w, ColsWeights) else w


def tf32x3_matmul_ref(a: torch.Tensor, w_hi: torch.Tensor,
                      w_lo: torch.Tensor) -> torch.Tensor:
    """a [M, K] float32 times W [K, N] given W's ``tf32_split``, as the
    float32 K3/K4 multiply: lo_a . hi_w + hi_a . lo_w + hi_a . hi_w."""
    a_hi, a_lo = tf32_split(a)
    return a_lo @ w_hi + a_hi @ w_lo + a_hi @ w_hi


def column_terms_ref(x_lr: torch.Tensor, x_hr: torch.Tensor, kf,
                     cw: ColsWeights) -> torch.Tensor:
    """Plain PyTorch version of the column-term pre-pass: the features
    times W_feat, plus ``kf * w_z`` (kf [n] or None) and the bias, in
    float32: [n, TERMS_COLS], the terms of layers 0, 2, 3, 4 of each MLP
    at ``TERM_LAYERS`` (pads 0). bf16 (``ColsPacked``): the features
    rounded to bf16 first; float32 (``ColsPackedTF32``, of ColsWeights
    or of the float32 K1's FusedWeights): the product in 3xTF32
    (:func:`tf32x3_matmul_ref`). Inputs may be strided views."""
    pk = cw.packed
    x = torch.cat([x_lr.float(), x_hr.float()], 1)
    if isinstance(pk, ColsPackedTF32):
        out = tf32x3_matmul_ref(x, *(w[:TERMS_COLS].t() for w in pk.wfeat))
    else:
        x = x.to(pk.wfeat.dtype).float()
        out = x @ pk.wfeat[:TERMS_COLS].float().t()
    out = out + pk.cvec[2]
    if kf is not None:
        out = out + kf.float()[:, None] * pk.cvec[0]
    return out


def chunk_plan(n: int, chunk: int = CHUNK_COLS) -> List[Tuple[int, int]]:
    """[start, stop) of each chunk of ``n`` columns the K3/K4 wrappers
    launch on (bf16 and float32), in order: every column once, the last
    chunk ragged."""
    return [(s, min(s + chunk, n)) for s in range(0, n, chunk)]


def _check_packed(cw):
    if not isinstance(cw, ColsWeights) or cw.packed is None:
        raise ValueError("the column kernels take prepare_cols_weights' "
                         "ColsWeights at the kernel's widths")
    return cw.packed


def _entries(pk) -> str:
    """The name suffix of a packing's chain kernels."""
    return "tf32x3" if isinstance(pk, ColsPackedTF32) else "wgmma"


def _launch_terms(lib, x_lr, x_hr, kf, pk, terms, stream):
    """The pre-pass of ``pk``'s dtype; the float32 one reads its inputs
    with row strides (K1's parts in place), the bf16 one contiguous."""
    n, c_lr = x_lr.shape
    kfp = None if kf is None else kf.data_ptr()
    w = (pk.wfeat.data_ptr(), pk.cvec.data_ptr(), terms.data_ptr(), stream)
    if isinstance(pk, ColsPackedTF32):
        rc = lib.surs_cols_terms_tf32x3(
            x_lr.data_ptr(), x_lr.stride(0), x_hr.data_ptr(), x_hr.stride(0),
            c_lr, kfp, 0 if kf is None else kf.stride(0), n, *w)
    else:
        rc = lib.surs_cols_terms_bf16(x_lr.data_ptr(), x_hr.data_ptr(), c_lr,
                                      kfp, n, *w)
    if rc != 0:
        raise RuntimeError("column-term pre-pass launch failed: "
                           + lib.surs_cuda_error_string(rc).decode())


def _terms_buffer(rows: int, dev) -> torch.Tensor:
    return torch.empty((-(-rows // TERMS_BLOCK) * TERMS_BLOCK, TERMS_COLS),
                       dtype=torch.float32, device=dev)


def column_terms(x_lr: torch.Tensor, x_hr: torch.Tensor, kf,
                 cw: ColsWeights) -> torch.Tensor:
    """The column-term pre-pass of K3/K4 alone (x_lr [n, C_lr], x_hr
    [n, C_hr], kf [n] or None, float32) -> [n, TERMS_COLS] float32. CUDA
    tensors launch ``cols_terms_bf16_kernel`` or, for the float32
    packing, ``cols_terms_tf32x3_kernel`` (counted in
    ``column_terms.launches``); CPU tensors take
    :func:`column_terms_ref`."""
    pk = _check_packed(cw)
    if _check_cols_inputs(x_lr, x_hr, cw.fw, []):
        return column_terms_ref(x_lr, x_hr, kf, cw)
    ins = [x_lr, x_hr] + ([] if kf is None else [kf])
    _check_kernel_inputs(ins, cw.fw)
    terms = _terms_buffer(x_lr.shape[0], x_lr.device)
    if x_lr.shape[0]:
        lib = _kernel_lib("fused_cols_mlp")
        with torch.cuda.device(x_lr.device):
            _launch_terms(lib, x_lr, x_hr, kf, pk, terms,
                          torch.cuda.current_stream().cuda_stream)
        column_terms.launches += 1
    return terms[:x_lr.shape[0]]


column_terms.launches = 0


# points per chunk of the plain versions: bounds their [rows, 1024]
# activations (a dense 512^3 grid would otherwise need 550 GB)
_REF_CHUNK_ROWS = 32768


def _cols_chain_ref(x_lr, x_hr, kf, zrow, rep: int, w, b, spec: MLPSpec,
                    xk: int, pred=None) -> torch.Tensor:
    """The TPU's ``_cols_chain`` (``surs_tpu/ops/fused_mlp.py:481-524``)
    over G columns, each expanded to ``rep`` rows: x_lr [G, C_lr], x_hr
    [G, C_hr] float32 holding compute-dtype values, kf [G] or None, zrow
    [G * rep] the depth feature of each row, pred [G * rep] or None ->
    logit [G * rep]."""
    cdt = w.dtype
    c_lr, F = x_lr.shape[1], x_lr.shape[1] + x_hr.shape[1]
    layout = _layout(spec, xk)
    h = None
    for i, (hb, xb, bo, n) in enumerate(layout):
        acc = None
        if xb is not None:
            wx = w[xb[0]:xb[0] + xk * n].view(xk, n).float()
            col = x_lr @ wx[:c_lr] + x_hr @ wx[c_lr:F]
            if kf is not None:
                col = col + kf[:, None] * wx[F]
            acc = (col.repeat_interleave(rep, 0)
                   + (zrow[:, None] * wx[F]).to(cdt).float())
        if hb is not None:
            wh = w[hb[0]:hb[0] + hb[1] * n].view(hb[1], n).float()
            d = h.to(cdt).float() @ wh
            acc = d if acc is None else acc + d
        if xb is not None and pred is not None:
            acc = acc + pred[:, None] * wx[F + 1]
        h = acc + b[bo:bo + n]
        if i < len(layout) - 1:
            h = torch.where(h >= 0, h, 0.01 * h)
    return h[:, 0]


def _dual_cols_ref(x_lr, x_hr, kf, zf, fw: FusedWeights):
    """Both MLPs of the column chain: G columns x len(zf) depths, row
    (g, t) at depth feature (kf[g] +) zf[t] -> ([G, Z], [G, Z])."""
    cdt = fw.w_lr.dtype
    G, Z = x_lr.shape[0], zf.shape[0]
    xl = x_lr.float().to(cdt).float()
    xh = x_hr.float().to(cdt).float()
    kf = None if kf is None else kf.float()
    zrow = zf.float().repeat(G)
    pred_lr = torch.sigmoid(_cols_chain_ref(xl, xh, kf, zrow, Z, fw.w_lr,
                                            fw.b_lr, fw.spec_lr, fw.xk))
    pred_hr = torch.sigmoid(_cols_chain_ref(xl, xh, kf, zrow, Z, fw.w_hr,
                                            fw.b_hr, fw.spec_hr, fw.xk,
                                            pred=pred_lr))
    return pred_hr.view(G, Z), pred_lr.view(G, Z)


def _chunked(x_lr, x_hr, kf, zf, dual):
    """``dual(x_lr, x_hr, kf, zf)`` over chunks of about _REF_CHUNK_ROWS
    points."""
    step = max(1, _REF_CHUNK_ROWS // max(zf.shape[0], 1))
    outs = [dual(x_lr[s:s + step], x_hr[s:s + step],
                 None if kf is None else kf[s:s + step], zf)
            for s in range(0, x_lr.shape[0], step)]
    if not outs:
        empty = x_lr.new_zeros((0, zf.shape[0]), dtype=torch.float32)
        return empty, empty.clone()
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))


def fused_dual_mlp_cols_ref(x_lr: torch.Tensor, x_hr: torch.Tensor,
                            zf: torch.Tensor, fw
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3, rounding where the Pallas body
    ``_kernel_cols`` rounds (features cast before their product, the
    depth term ``zf * w_z`` rounded after it, pred_lr not rounded):
    x_lr [Ncol, C_lr], x_hr [Ncol, C_hr], zf [Z], ``fw`` FusedWeights or
    ColsWeights -> (pred_hr [Ncol, Z], pred_lr [Ncol, Z]) float32, in
    column chunks."""
    return _chunked(x_lr, x_hr, None, zf,
                    functools.partial(_dual_cols_ref, fw=_fw_of(fw)))


def fused_dual_mlp_runs_ref(x_lr: torch.Tensor, x_hr: torch.Tensor,
                            kf: torch.Tensor, zt: torch.Tensor, fw
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K4: window w, depth t has the depth
    feature kf[w] + zt[t], with ``kf * w_z`` in float32 (unrounded) and
    ``zt * w_z`` rounded as K3's depth term. x_lr [NR, C_lr], x_hr
    [NR, C_hr], kf [NR], zt [zb] -> ([NR, zb], [NR, zb]) float32."""
    return _chunked(x_lr, x_hr, kf, zt,
                    functools.partial(_dual_cols_ref, fw=_fw_of(fw)))


def _cols_chain_tf32x3_ref(terms, zrow, rep: int, hid, pk, m: int,
                           pred=None) -> torch.Tensor:
    """The float32 K3/K4's chain of MLP ``m`` (0 coarse, 1 fine) over G
    columns' (windows') terms [G, TERMS_COLS], each expanded to ``rep``
    rows at depth features zrow [G * rep], pred [G * rep] or None, hid
    {layer: (hi, lo) [in, out]} -> logit [G * rep]."""
    o = m * TERMS_MLP
    t = terms[:, o:o + TERMS_MLP].repeat_interleave(rep, 0)
    wz, wp = pk.cvec[0, o:o + TERMS_MLP], pk.cvec[1, o:o + TERMS_MLP]
    d = KERNEL_DIMS_LR

    def x_term(layer):
        off = dict(TERM_LAYERS)[layer]
        n = d[layer + 1]
        v = t[:, off:off + n] + zrow[:, None] * wz[off:off + n]
        return v if pred is None else v + pred[:, None] * wp[off:off + n]

    def leaky(v):
        return torch.where(v >= 0, v, 0.01 * v)

    h = leaky(x_term(0))
    h = leaky(tf32x3_matmul_ref(h, *hid[1]) + pk.hvec[m, :d[2]])
    h = leaky(tf32x3_matmul_ref(h, *hid[2]) + x_term(2))
    h = leaky(tf32x3_matmul_ref(h, *hid[3]) + x_term(3))
    return h @ pk.hvec[m, d[2]:] + x_term(4)[:, 0]


def _dual_cols_tf32x3_ref(x_lr, x_hr, kf, zf, cw, hid):
    pk = cw.packed
    G, Z = x_lr.shape[0], zf.shape[0]
    terms = column_terms_ref(x_lr, x_hr, kf, cw)
    zrow = zf.float().repeat(G)
    pred_lr = torch.sigmoid(_cols_chain_tf32x3_ref(terms, zrow, Z, hid[0],
                                                   pk, 0))
    pred_hr = torch.sigmoid(_cols_chain_tf32x3_ref(terms, zrow, Z, hid[1],
                                                   pk, 1, pred=pred_lr))
    return pred_hr.view(G, Z), pred_lr.view(G, Z)


def _tf32x3_chunked(x_lr, x_hr, kf, zf, cw):
    pk = _check_packed(cw)
    if not isinstance(pk, ColsPackedTF32):
        raise ValueError("the 3xTF32 plain versions take the float32 "
                         "ColsWeights of prepare_cols_weights")
    hid = [unpack_hidden_tf32(pk.whid[m]) for m in (0, 1)]
    return _chunked(x_lr, x_hr, kf, zf, functools.partial(
        _dual_cols_tf32x3_ref, cw=cw, hid=hid))


def fused_dual_mlp_cols_tf32x3_ref(x_lr: torch.Tensor, x_hr: torch.Tensor,
                                   zf: torch.Tensor, cw: ColsWeights
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The float32 K3's arithmetic from the plain versions of its
    kernels: the pre-pass in 3xTF32 (:func:`column_terms_ref`), then per
    MLP layer 0 from the terms, layers 1-3 as 3xTF32 products
    (:func:`tf32x3_matmul_ref`) on the packing's own hi / lo weights
    (:func:`unpack_hidden_tf32`), the last layer in float32, nothing
    rounded between layers. The float32 ColsWeights -> (pred_hr [Ncol,
    Z], pred_lr [Ncol, Z])."""
    return _tf32x3_chunked(x_lr, x_hr, None, zf, cw)


def fused_dual_mlp_runs_tf32x3_ref(x_lr: torch.Tensor, x_hr: torch.Tensor,
                                   kf: torch.Tensor, zt: torch.Tensor,
                                   cw: ColsWeights
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The float32 K4's arithmetic, as
    :func:`fused_dual_mlp_cols_tf32x3_ref` with ``kf * w_z`` in the
    column terms: window w, depth t at kf[w] + zt[t] -> ([NR, zb],
    [NR, zb])."""
    return _tf32x3_chunked(x_lr, x_hr, kf, zt, cw)


def _check_cols_inputs(x_lr, x_hr, fw: FusedWeights, depth_shapes) -> bool:
    """Check the column kernels' inputs (``depth_shapes``: (tensor,
    expected shape) pairs); True for CPU tensors, which take the plain
    version."""
    n = x_lr.shape[0]
    if x_lr.dim() != 2 or x_hr.dim() != 2 or x_hr.shape[0] != n \
            or x_lr.shape[1] + x_hr.shape[1] != fw.spec_lr.dims[0] - 1:
        raise ValueError(
            f"x_lr {tuple(x_lr.shape)} and x_hr {tuple(x_hr.shape)} do not "
            f"make [n, {fw.spec_lr.dims[0] - 1}] features")
    for t, shape in depth_shapes:
        if tuple(t.shape) != shape:
            raise ValueError(f"expected a depth input of shape {shape}, "
                             f"got {tuple(t.shape)}")
    dev = x_lr.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the column kernels run on CUDA or CPU tensors, "
                         f"not {dev}")
    return dev.type == "cpu"


def _cols_wgmma(wrapper, x_lr, x_hr, kf, pk, shape, launch,
                chunk: int = CHUNK_COLS):
    """K3/K4 (and the float32 K1) on the card: per chunk of ``chunk``
    columns, the pre-pass into one reused column-term buffer, then the
    chain kernel (``launch(lib, terms, s, e, out_hr, out_lr, stream)``)
    into outputs of ``shape``; one count on ``wrapper`` per call."""
    n, dev = x_lr.shape[0], x_lr.device
    out_hr = torch.empty(shape, dtype=torch.float32, device=dev)
    out_lr = torch.empty(shape, dtype=torch.float32, device=dev)
    if out_hr.numel() == 0:
        return out_hr, out_lr
    lib = _kernel_lib("fused_cols_mlp")
    plan = chunk_plan(n, chunk)
    terms = _terms_buffer(plan[0][1] - plan[0][0], dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for s, e in plan:
            _launch_terms(lib, x_lr[s:e], x_hr[s:e],
                          None if kf is None else kf[s:e], pk, terms, stream)
            rc = launch(lib, terms, s, e, out_hr, out_lr, stream)
            if rc != 0:
                raise RuntimeError(f"{wrapper.__name__} launch failed: "
                                   + lib.surs_cuda_error_string(rc).decode())
    wrapper.launches += 1
    return out_hr, out_lr


def fused_dual_mlp_cols(x_lr: torch.Tensor, x_hr: torch.Tensor,
                        zf: torch.Tensor, fw
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Column-shared dual MLP (``surs_tpu/ops/fused_mlp.py:576``): x_lr
    [Ncol, C_lr], x_hr [Ncol, C_hr] per-column features, zf [Z] the
    shared depth features -> (pred_hr [Ncol, Z], pred_lr [Ncol, Z])
    float32, the [column, depth] volume layout. Any Z. ``fw``: the
    ColsWeights of :func:`prepare_cols_weights` (or, CPU only, their
    FusedWeights). CUDA tensors launch kernel K3: per chunk of
    ``CHUNK_COLS`` columns the pre-pass and the wgmma chain, in bf16 or
    (the float32 packing) in 3xTF32, counted once per call in
    ``fused_dual_mlp_cols.launches``; without the packing they raise. CPU
    tensors take :func:`fused_dual_mlp_cols_ref`; anything else
    raises."""
    w = _fw_of(fw)
    if _check_cols_inputs(x_lr, x_hr, w, [(zf, (zf.shape[0],))]):
        return fused_dual_mlp_cols_ref(x_lr, x_hr, zf, w)
    _check_kernel_inputs([x_lr, x_hr, zf], w)
    z = zf.shape[0]
    pk = _check_packed(fw)
    entry = f"surs_fused_dual_mlp_cols_{_entries(pk)}"

    def launch(lib, terms, s, e, out_hr, out_lr, stream):
        return getattr(lib, entry)(
            terms.data_ptr(), zf.data_ptr(), e - s, z, pk.whid.data_ptr(),
            pk.cvec.data_ptr(), pk.hvec.data_ptr(), out_hr[s:e].data_ptr(),
            out_lr[s:e].data_ptr(), stream)
    return _cols_wgmma(fused_dual_mlp_cols, x_lr, x_hr, None, pk,
                       (x_lr.shape[0], z), launch)


fused_dual_mlp_cols.launches = 0

# depths per window the CUDA kernel K4 is built for
RUNS_WINDOW = 8


def fused_dual_mlp_runs(x_lr: torch.Tensor, x_hr: torch.Tensor,
                        kf: torch.Tensor, zt: torch.Tensor, fw
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Window dual MLP (``surs_tpu/ops/fused_mlp.py:728``): x_lr
    [NR, C_lr], x_hr [NR, C_hr] per-window column features, kf [NR]
    float32 per-window depth offsets, zt [zb] the shared in-window
    depths -> ([NR, zb], [NR, zb]) float32; row (w, t) is scored at
    depth feature kf[w] + zt[t]. ``fw`` as for :func:`fused_dual_mlp_cols`.
    CUDA tensors launch kernel K4 (zb = 8; in chunks as K3, bf16 or
    3xTF32 by the packing, raising without it; counted once per call in
    ``fused_dual_mlp_runs.launches``); CPU tensors take
    :func:`fused_dual_mlp_runs_ref`; anything else raises."""
    w = _fw_of(fw)
    nr = x_lr.shape[0]
    if _check_cols_inputs(x_lr, x_hr, w, [(kf, (nr,)),
                                          (zt, (zt.shape[0],))]):
        return fused_dual_mlp_runs_ref(x_lr, x_hr, kf, zt, w)
    if zt.shape[0] != RUNS_WINDOW:
        raise ValueError(f"K4 is built for {RUNS_WINDOW}-deep windows, got "
                         f"zt of {zt.shape[0]}")
    _check_kernel_inputs([x_lr, x_hr, kf, zt], w)
    pk = _check_packed(fw)
    entry = f"surs_fused_dual_mlp_runs_{_entries(pk)}"

    def launch(lib, terms, s, e, out_hr, out_lr, stream):
        return getattr(lib, entry)(
            terms.data_ptr(), zt.data_ptr(), e - s, pk.whid.data_ptr(),
            pk.cvec.data_ptr(), pk.hvec.data_ptr(), out_hr[s:e].data_ptr(),
            out_lr[s:e].data_ptr(), stream)
    return _cols_wgmma(fused_dual_mlp_runs, x_lr, x_hr, kf, pk,
                       (nr, RUNS_WINDOW), launch)


fused_dual_mlp_runs.launches = 0


# ------------------------------------------------------- float32 K1 -----
# The float32 K1 runs the float32 K3/K4's kernels with one point a row: the
# pre-pass with the point's depth (input column FEAT) as kf, then the
# chain (csrc/fused_cols_mlp.cu: fused_dual_mlp_points_tf32x3_kernel).
# Points per pre-pass / chain launch pair: the evaluators' 50,000-point
# calls run in one pair (fewer waves of the persistent chain than two
# chunks of CHUNK_COLS), their [50,048, TERMS_COLS] float32 terms 565 MB
# of scratch; larger calls in chunks of this many, at most 740 MB.
K1_CHUNK_POINTS = 65536


def _k1_split(parts: List[torch.Tensor]):
    """(x_lr, x_hr, kf): views of K1's one or two input parts as the
    pre-pass reads them, no copy. The features split where the parts do
    (one part: all FEAT in x_lr, x_hr empty); kf the depth column FEAT."""
    p0 = parts[0]
    if p0.shape[1] > FEAT:
        return p0[:, :FEAT], p0[:, FEAT:FEAT], p0[:, FEAT]
    c = FEAT - p0.shape[1]
    return p0, parts[1][:, :c], parts[1][:, c]


def _k1_f32_packing(fw) -> ColsPackedTF32:
    pk = fw.packed
    if not isinstance(pk, ColsPackedTF32):
        raise ValueError("the float32 K1 takes prepare_fused_weights' "
                         "packing (weights on the card, at the kernel's "
                         "widths) or the float32 ColsWeights")
    return pk


def fused_dual_mlp_tf32x3_ref(x, w) -> Tuple[torch.Tensor, torch.Tensor]:
    """The float32 K1's arithmetic from the plain versions of its
    kernels: :func:`column_terms_ref` with kf the depth column, then per
    MLP the float32 K3/K4's chain one row a point with no in-chain depth,
    pred_lr entering the fine MLP unrounded. ``x`` as for
    :func:`fused_dual_mlp`; ``w`` the float32 FusedWeights with their
    packing, or the float32 ColsWeights of the same MLPs -> (pred_hr [N],
    pred_lr [N])."""
    parts = _k1_parts(x, _fw_of(w))
    pk = _k1_f32_packing(w)
    hid = [unpack_hidden_tf32(pk.whid[m]) for m in (0, 1)]
    x_lr, x_hr, kf = _k1_split(parts)
    hr, lr = _chunked(x_lr, x_hr, kf, x_lr.new_zeros(1), functools.partial(
        _dual_cols_tf32x3_ref, cw=w, hid=hid))
    return hr[:, 0], lr[:, 0]


def k1_scratch_bytes(n: int) -> int:
    """Bytes of the float32 K1's column-term buffer for an n-point call:
    one chunk's rows, rounded up to the pre-pass's blocks."""
    rows = min(n, K1_CHUNK_POINTS)
    return -(-rows // TERMS_BLOCK) * TERMS_BLOCK * TERMS_COLS * 4


def _k1_tf32x3(parts: List[torch.Tensor], fw: FusedWeights):
    pk = _k1_f32_packing(fw)
    x_lr, x_hr, kf = _k1_split(parts)

    def launch(lib, terms, s, e, out_hr, out_lr, stream):
        return lib.surs_fused_dual_mlp_points_tf32x3(
            terms.data_ptr(), e - s, pk.whid.data_ptr(), pk.cvec.data_ptr(),
            pk.hvec.data_ptr(), out_hr[s:e].data_ptr(),
            out_lr[s:e].data_ptr(), stream)
    return _cols_wgmma(fused_dual_mlp, x_lr, x_hr, kf, pk, (x_lr.shape[0],),
                       launch, chunk=K1_CHUNK_POINTS)


# ---------------------------------------------------------------- launch --
def _launch(wrapper, lib_name: str, fn_name: str, fw: FusedWeights, shape,
            inputs, weights):
    """Launch ``fn_name`` of kernel library ``lib_name`` on the current
    stream of the weights' device with ``inputs`` + ``weights`` + two
    float32 outputs of ``shape``; count the launch on ``wrapper``. Raises
    if it fails."""
    dev = fw.w_lr.device
    out_hr = torch.empty(shape, dtype=torch.float32, device=dev)
    out_lr = torch.empty(shape, dtype=torch.float32, device=dev)
    if out_hr.numel() == 0:
        return out_hr, out_lr
    lib = _kernel_lib(lib_name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, fn_name)(
            *inputs, *(t.data_ptr() for t in weights), out_hr.data_ptr(),
            out_lr.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{wrapper.__name__} launch failed: "
                           + lib.surs_cuda_error_string(rc).decode())
    wrapper.launches += 1
    return out_hr, out_lr


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# K3 / K4 in either dtype: the chains
_K3 = [_P, _P, _I, _I] + [_P] * 6
_K4 = [_P, _P, _I] + [_P] * 6
# each library's entry points and their argument types
_SIGNATURES = {
    "fused_dual_mlp": {
        "surs_fused_dual_mlp_bf16": [_P, _I, _P, _I, _I] + [_P] * 6,
    },
    "fused_train_tf32": {
        "surs_fused_dual_mlp_train_tf32x3": [_P, _P, _P, _I, _I] + [_P] * 9,
        "surs_k2_pack_weights": [_P] * 4,
        "surs_tf32x3_gemm": [_P, _P, _I, _P, _P, _I] + [_P] * 5
                            + [_I, _I, _P],
    },
    "fused_cols_mlp": {
        "surs_cols_terms_bf16": [_P, _P, _I, _P, _I] + [_P] * 4,
        "surs_cols_terms_tf32x3": [_P, _L, _P, _L, _I, _P, _L, _I]
                                  + [_P] * 4,
        "surs_fused_dual_mlp_cols_wgmma": _K3,
        "surs_fused_dual_mlp_cols_tf32x3": _K3,
        "surs_fused_dual_mlp_runs_wgmma": _K4,
        "surs_fused_dual_mlp_runs_tf32x3": _K4,
        "surs_fused_dual_mlp_points_tf32x3": [_P, _I] + [_P] * 6,
    },
}


def _kernel_lib(name: str) -> ctypes.CDLL:
    from .cuda_build import load
    lib = load(name)
    if not getattr(lib, "_surs_bound", False):
        for fn_name, argtypes in _SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.surs_cuda_error_string.argtypes = [ctypes.c_int]
        lib.surs_cuda_error_string.restype = ctypes.c_char_p
        lib._surs_bound = True
    return lib
