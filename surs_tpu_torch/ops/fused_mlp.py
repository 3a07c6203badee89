"""Kernels K1 and K2: the fused dual occupancy MLP for serving and for
training, each beside its plain version.

K1 is the counterpart of ``fused_dual_mlp`` in
``surs_tpu/ops/fused_mlp.py`` (Pallas body ``_kernel``). Per point: the
coarse MLP (dims_lr, input re-concatenated before ``res_layers``,
leaky-ReLU 0.01, sigmoid) gives pred_lr; the fine MLP runs on
[x, pred_lr] and gives pred_hr.

K2 is the counterpart of ``fused_dual_mlp_train`` (Pallas body
``_kernel_train``): the coarse MLP runs on ``xa``, the fine MLP on
[xb, mask_a * pred_lr]; both outputs unmasked. Its autograd op
(``make_fused_dual_mlp_train_ad``) launches K2 forward and, like the JAX
custom_vjp, differentiates a recompute of the plain version backward.

``prepare_fused_weights`` packs each MLP's weights into one flat buffer
in the compute dtype, each layer split into the row block that
multiplies the previous activation (``h``) and the row block that
multiplies the input (``x``, zero-padded to ``XK`` rows), and the biases
into one float32 buffer. The CUDA kernel (``csrc/fused_dual_mlp.cu``)
and the plain version read the same buffers. The TPU layout (128-lane
padding) is not carried over.

``fused_dual_mlp`` launches the kernel for CUDA tensors and takes the
plain version only for CPU tensors. The plain version rounds where the
TPU kernel rounds: the input, each activation and pred_lr are cast to
the compute dtype before their product; sums, bias, leaky-ReLU and
sigmoid are float32.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Sequence, Tuple

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


class FusedWeights(NamedTuple):
    w_lr: torch.Tensor    # packed weights, compute dtype
    b_lr: torch.Tensor    # packed biases, float32
    w_hr: torch.Tensor
    b_hr: torch.Tensor
    spec_lr: MLPSpec
    spec_hr: MLPSpec
    xk: int               # padded input width (dims_hr[0] rounded to 16)


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
    must be dims_lr[0] + 1."""
    return _pack_pair([p.detach() for p in mlp_params(mlp_lr)],
                      [p.detach() for p in mlp_params(mlp_hr)],
                      _specs(mlp_lr, mlp_hr), dtype)


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


def fused_dual_mlp(x, fw: FusedWeights) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both occupancy MLPs over point features.

    ``x``: [N, dims_lr[0]] float32, or a sequence of parts [N, w_i]
    (e.g. the (256, 65) split of lr features | hr features + depth).
    Returns (pred_hr [N], pred_lr [N]) float32 in [0, 1]. CUDA tensors
    launch kernel K1 (counted in ``fused_dual_mlp.launches``); CPU tensors
    take :func:`fused_dual_mlp_ref`; anything else raises.
    """
    parts = list(x) if isinstance(x, (list, tuple)) else [x]
    N = parts[0].shape[0]
    widths = [p.shape[1] for p in parts]
    if any(p.dim() != 2 or p.shape[0] != N for p in parts) \
            or sum(widths) != fw.spec_lr.dims[0]:
        raise ValueError(f"input parts {[tuple(p.shape) for p in parts]} "
                         f"do not make [N, {fw.spec_lr.dims[0]}]")
    dev = parts[0].device
    if dev.type == "cpu":
        return fused_dual_mlp_ref(parts, fw)
    if dev.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or CPU tensors, not {dev}")
    if len(parts) > 2:
        raise ValueError("K1 takes one or two input parts")
    _check_kernel_inputs(parts, fw)
    x1 = parts[1] if len(parts) == 2 else None
    fn = ("surs_fused_dual_mlp_bf16" if fw.w_lr.dtype == torch.bfloat16
          else "surs_fused_dual_mlp_f32")
    return _launch(fused_dual_mlp, fn, fw, N, (
        parts[0].data_ptr(), widths[0],
        x1.data_ptr() if x1 is not None else None,
        widths[1] if x1 is not None else 0, N))


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


def fused_dual_mlp_train(xa: torch.Tensor, xb: torch.Tensor,
                         mask_a: torch.Tensor, fw: FusedWeights
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train-time dual chain: coarse MLP on ``xa`` [N, dims_lr[0]], fine
    MLP on ``xb`` [N, dims_lr[0]] + (``mask_a`` [N] * coarse prediction).
    Returns (pred_hr [N], pred_lr [N]) float32, both unmasked. CUDA
    tensors launch kernel K2 (float32 weights; counted in
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
    return _launch(fused_dual_mlp_train, "surs_fused_dual_mlp_train_f32",
                   fw, N, (xa.data_ptr(), xb.data_ptr(), mask_a.data_ptr(),
                           C, N))


fused_dual_mlp_train.launches = 0


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


def _launch(wrapper, fn_name: str, fw: FusedWeights, n: int, inputs):
    """Launch ``fn_name`` of the kernel library on the current stream of
    the weights' device with ``inputs`` + weights + two [n] float32
    outputs; count the launch on ``wrapper``. Raises if it fails."""
    dev = fw.w_lr.device
    out_hr = torch.empty(n, dtype=torch.float32, device=dev)
    out_lr = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return out_hr, out_lr
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, fn_name)(
            *inputs, fw.w_lr.data_ptr(), fw.b_lr.data_ptr(),
            fw.w_hr.data_ptr(), fw.b_hr.data_ptr(), out_hr.data_ptr(),
            out_lr.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{wrapper.__name__} launch failed: "
                           + lib.surs_cuda_error_string(rc).decode())
    wrapper.launches += 1
    return out_hr, out_lr


def _kernel_lib() -> ctypes.CDLL:
    from .cuda_build import load
    lib = load("fused_dual_mlp")
    if not getattr(lib, "_surs_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.surs_fused_dual_mlp_bf16, lib.surs_fused_dual_mlp_f32):
            fn.argtypes = [p, i, p, i, i, p, p, p, p, p, p, p]
            fn.restype = ctypes.c_int
        lib.surs_fused_dual_mlp_train_f32.argtypes = [p, p, p, i, i, p, p, p,
                                                      p, p, p, p]
        lib.surs_fused_dual_mlp_train_f32.restype = ctypes.c_int
        lib.surs_cuda_error_string.argtypes = [ctypes.c_int]
        lib.surs_cuda_error_string.restype = ctypes.c_char_p
        lib._surs_bound = True
    return lib
