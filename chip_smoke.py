#!/usr/bin/env python3
"""Drive the PyTorch port (surs_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

  1. build:   compile every CUDA kernel of the serving path with nvcc from
              the repository's sources (one nvcc per source, in parallel).
  2. k1:      kernel K1 (fused dual MLP) against its plain PyTorch version
              on the card, at the serving shapes (N = 50,000 and a ragged
              49,999; the (256, 65) input split; full widths), in bf16 and
              float32, with the kernel's and the plain version's times and
              the card's bound for the same work.
  3. serve:   SuRSService at the reference model's full width (loadSize
              512, hg_dim 256, 3 lr stacks, the reference MLPs; seeded
              random weights) reconstructs 3 synthetic subjects at 512^3
              with silhouette pruning; K1's launch count is zeroed just
              before and read just after.
  4. check:   the card's results against references: the served query
              path against the model's float32 reference chain at full
              width, a full-resolution field's range, and a small float32
              service on the card against the same service on the CPU.
  5. stages:  one subject's time by stage (encode, evaluate, extract,
              write).

Then a ``{"kernels": [...]}`` line, the card's name and power limit as
nvidia-smi reports them, and last ``{"ok": true, "device": {...}}``.
Exits non-zero without a result when no CUDA device is present.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 3
N_MAIN = 50_000
# published dense peaks of an H100 SXM and its memory rate
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
# K1 against its plain version, max |difference| of pred_hr and pred_lr.
# bf16: both round the input, every activation and pred_lr to bf16 and
# sum in float32; only the summation order differs, which can flip a
# bf16 rounding (2^-8 relative) of an activation now and then.
# float32: the same products summed in another order, ~1e-7 relative per
# sum of ~1000 terms, on outputs in [0, 1].
K1_TOL = {"bfloat16": 5e-3, "float32": 1e-5}
# the served path (bf16 weights and features) against the model's float32
# reference chain: bf16 rounds weights and activations (2^-9 relative)
# at each of five layers per MLP
SERVE_TOL = 2e-2
# the float32 service on the card against the same service on the CPU
# (cuDNN and cuBLAS in float32, TF32 off)
F32_SERVICE_TOL = 1e-4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def k1_work(dims_lr, dims_hr, n: int, dtype: str):
    """(flops, bytes) K1 must do for n points: real MAC counts of both
    MLPs, each input byte read once, weights once, outputs written once."""
    macs = 0
    weights = 0
    for dims in (dims_lr, dims_hr):
        for i in range(len(dims) - 1):
            fan_in = dims[i] + (dims[0] if i in (2, 3, 4) else 0)
            macs += fan_in * dims[i + 1]
            weights += fan_in * dims[i + 1]
    wbytes = 2 if dtype == "bfloat16" else 4
    nbytes = n * dims_lr[0] * 4 + weights * wbytes + n * 2 * 4
    return 2.0 * macs * n, float(nbytes)


def time_cuda(fn, reps: int, warm: int = 2) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events."""
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def phase_build():
    from surs_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    cuda_build.build(["fused_dual_mlp"])
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, (_, log) in cuda_build.BUILD_LOG.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": ptxas})


def phase_k1():
    import torch
    from surs_tpu_torch.models.layers import init_weights
    from surs_tpu_torch.models.surface_classifier import SurfaceClassifier
    from surs_tpu_torch.ops import fused_mlp as fm

    gen = torch.Generator().manual_seed(SEED)
    mlp_lr = SurfaceClassifier(fm.KERNEL_DIMS_LR)
    mlp_hr = SurfaceClassifier(fm.KERNEL_DIMS_HR)
    init_weights(mlp_lr, gen)
    init_weights(mlp_hr, gen)
    # larger-than-init weights so the outputs spread over (0, 1)
    with torch.no_grad():
        for p in list(mlp_lr.parameters()) + list(mlp_hr.parameters()):
            p.mul_(3.0)
    mlp_lr.cuda()
    mlp_hr.cuda()
    rng = np.random.default_rng(SEED)
    results = {}
    for dtype_name, dtype in (("bfloat16", torch.bfloat16),
                              ("float32", torch.float32)):
        fw = fm.prepare_fused_weights(mlp_lr, mlp_hr, dtype=dtype)
        for n in (N_MAIN, N_MAIN - 1):
            x_lr = torch.from_numpy(rng.standard_normal(
                (n, 256)).astype(np.float32)).cuda()
            xz = torch.from_numpy(rng.standard_normal(
                (n, 65)).astype(np.float32)).cuda()
            parts = [x_lr, xz]
            hr, lr = fm.fused_dual_mlp(parts, fw)
            torch.cuda.synchronize()
            ref_hr, ref_lr = fm.fused_dual_mlp_ref(parts, fw)
            ok = bool(torch.isfinite(hr).all() and torch.isfinite(lr).all())
            err = max((hr - ref_hr).abs().max().item(),
                      (lr - ref_lr).abs().max().item())
            rec = {"phase": "k1", "dtype": dtype_name, "n": n,
                   "max_abs_err": err, "tol": K1_TOL[dtype_name],
                   "pred_hr_range": [hr.min().item(), hr.max().item()]}
            if n == N_MAIN:
                flops, nbytes = k1_work(fm.KERNEL_DIMS_LR,
                                        fm.KERNEL_DIMS_HR, n, dtype_name)
                t_op = flops / PEAK_FLOPS[dtype_name] * 1e3
                t_mem = nbytes / HBM_BYTES_PER_S * 1e3
                rec.update(
                    ms=time_cuda(lambda: fm.fused_dual_mlp(parts, fw), 20),
                    plain_ms=time_cuda(
                        lambda: fm.fused_dual_mlp_ref(parts, fw), 5),
                    bound_ms=max(t_op, t_mem),
                    bound_by="operations" if t_op >= t_mem else "bytes",
                    gflop=flops / 1e9)
                rec["tflops"] = flops / (rec["ms"] * 1e-3) / 1e12
            emit(rec)
            results[(dtype_name, n)] = rec
            if not ok or not err <= K1_TOL[dtype_name]:
                raise AssertionError(f"K1 disagrees with its plain version: "
                                     f"{rec}")
    return results


def synthetic_subject(i: int, S: int = 256):
    rng = np.random.default_rng(SEED + i)
    img = (rng.random((S, S, 3)) * 255).astype(np.uint8)
    yy, xx = np.mgrid[:S, :S]
    cx, cy = S / 2 + 6 * i, S / 2 - 4 * i
    ax, ay = S * (0.22 + 0.02 * i), S * 0.40
    mask = ((((xx - cx) / ax) ** 2 + ((yy - cy) / ay) ** 2) < 1
            ).astype(np.uint8) * 255
    return img, mask


def full_width_config(**kw):
    from surs_tpu_torch.config import SuRSConfig
    return SuRSConfig(loadSize=512, hg_dim=256, num_stack_lr=3,
                      resolution=512, mask_prune=True,
                      b_min=[-0.5, -0.5, -0.5], b_max=[0.5, 0.5, 0.5],
                      seed=SEED, **kw)


def phase_serve(out_dir: str):
    import torch
    from surs_tpu_torch.ops.fused_mlp import fused_dual_mlp
    from surs_tpu_torch.serve import SuRSService

    t0 = time.perf_counter()
    service = SuRSService(full_width_config())
    warm = service.warmup((256, 256))
    emit({"phase": "serve_setup", "build_seconds": time.perf_counter() - t0,
          "warmup_seconds": warm, "dtype": service.cfg.dtype,
          "feature_dtype": service.cfg.feature_dtype})
    subjects = [synthetic_subject(i) for i in range(3)]
    torch.cuda.synchronize()
    fused_dual_mlp.launches = 0          # main path starts here
    per = []
    for i, (img, mask) in enumerate(subjects):
        stats = {}
        t1 = time.perf_counter()
        p_hr, p_lr = service.reconstruct(img, mask, f"subject{i}", out_dir,
                                         stats=stats)
        per.append({"seconds": time.perf_counter() - t1,
                    "queries": stats["queries"],
                    "faces_hr": stats["faces"][0],
                    "faces_lr": stats["faces"][1],
                    "obj_bytes": [os.path.getsize(p_hr),
                                  os.path.getsize(p_lr)]})
    torch.cuda.synchronize()
    launches = fused_dual_mlp.launches   # main path ends here
    rec = {"phase": "serve", "resolution": service.cfg.resolution,
           "requests": per, "k1_launches": launches,
           "seconds_per_request": float(np.mean([r["seconds"]
                                                 for r in per]))}
    emit(rec)
    for i, r in enumerate(per):
        for suffix in ("_HR.obj", "_LR.obj"):
            if not os.path.isfile(os.path.join(out_dir,
                                               f"subject{i}{suffix}")):
                raise AssertionError(f"subject{i}{suffix} not written")
        if r["faces_lr"] <= 0:
            raise AssertionError(f"subject{i}: empty LR mesh")
    if launches <= 0:
        raise AssertionError("the main path never launched K1")
    return service, subjects, rec


def phase_check(service, subjects):
    import torch
    from surs_tpu_torch.ops.point_query import fused_query
    from surs_tpu_torch.recon.pipeline import eval_calibration
    from surs_tpu_torch.serve import SuRSService, normalize_image

    rec = {"phase": "check"}
    # (a) served query (K1, bf16) vs the model's float32 reference chain
    img, mask = subjects[0]
    arr, _ = normalize_image(img, mask)
    _, feats_lr, feat_hr = service.rec.encode(arr)
    f_lr = feats_lr[-1].to(torch.bfloat16)
    f_hr = feat_hr.to(torch.bfloat16)
    rng = np.random.default_rng(SEED)
    pts = torch.from_numpy(rng.uniform(-0.5, 0.5, (1, 3, N_MAIN)).astype(
        np.float32)).cuda()
    calib = torch.from_numpy(eval_calibration(1)).cuda()
    with torch.inference_mode():
        got = fused_query(service.weights, f_lr, f_hr, pts, calib,
                          service.cfg.loadSize, service.cfg.z_size)
        want = service.model.query([f_lr], f_hr, pts, calib)
    rec["query_vs_f32_chain"] = max((g - w).abs().max().item()
                                    for g, w in zip(got, want))
    rec["query_tol"] = SERVE_TOL
    # (b) a full-resolution field: shape, finite, in [0, 1]
    sdf_hr, sdf_lr = service.fields(img, mask)
    rng_ok = all(bool(torch.isfinite(s).all()) and s.min().item() >= 0.0
                 and s.max().item() <= 1.0 for s in (sdf_hr, sdf_lr))
    rec["field_shape"] = list(sdf_hr.shape)
    rec["field_lr_range"] = [sdf_lr.min().item(), sdf_lr.max().item()]
    del sdf_hr, sdf_lr
    # (c) a small float32 service on the card vs the same on the CPU
    small = dict(loadSize=32, num_stack_lr=1, resolution=32,
                 octree_init_resolution=8, num_samples=4096,
                 b_min=[-0.5] * 3, b_max=[0.5] * 3, dtype="float32",
                 feature_dtype="float32", seed=SEED)
    from surs_tpu_torch.config import SuRSConfig
    s_img, s_mask = synthetic_subject(0, S=16)
    on_card = SuRSService(SuRSConfig(**small)).fields(s_img, s_mask)
    on_cpu = SuRSService(SuRSConfig(**small), device="cpu").fields(
        s_img, s_mask)
    rec["f32_service_card_vs_cpu"] = max(
        (a.cpu() - b).abs().max().item() for a, b in zip(on_card, on_cpu))
    rec["f32_service_tol"] = F32_SERVICE_TOL
    emit(rec)
    if not (rec["query_vs_f32_chain"] <= SERVE_TOL and rng_ok
            and rec["field_shape"] == [service.cfg.resolution] * 3
            and rec["f32_service_card_vs_cpu"] <= F32_SERVICE_TOL):
        raise AssertionError(f"check failed: {rec}")


def phase_stages(service, subjects, out_dir: str):
    """One subject's wall time by stage, each ending in a synchronize."""
    import torch
    from surs_tpu_torch.recon.mesh_io import save_obj_mesh
    from surs_tpu_torch.recon.pipeline import eval_calibration
    from surs_tpu_torch.serve import normalize_image

    img, mask = subjects[1]
    arr, m = normalize_image(img, mask)
    cfg = service.cfg
    t = [time.perf_counter()]

    def mark():
        torch.cuda.synchronize()
        t.append(time.perf_counter())

    _, feats_lr, feat_hr = service.rec.encode(arr)
    mark()
    stats = {}
    sdf_hr, sdf_lr, mat = service.rec.evaluate(
        feats_lr, feat_hr, eval_calibration(1), cfg.resolution, cfg.b_min,
        cfg.b_max, num_samples=cfg.num_samples, threshold=cfg.threshold,
        init_resolution=cfg.octree_init_resolution, silhouette=m,
        stats=stats)
    mark()
    meshes = list(service.rec.extract_pair(sdf_hr, sdf_lr, mat))
    mark()
    for name, (v, f) in zip(("HR", "LR"), meshes):
        save_obj_mesh(os.path.join(out_dir, f"stages_{name}.obj"), v, f)
    mark()
    d = np.diff(t)
    emit({"phase": "stages", "encode_s": d[0], "evaluate_s": d[1],
          "extract_s": d[2], "write_s": d[3], "queries": stats["queries"],
          "faces": [len(f) for _, f in meshes]})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    k1 = phase_k1()
    with tempfile.TemporaryDirectory() as out_dir:
        service, subjects, serve = phase_serve(out_dir)
        phase_check(service, subjects)
        phase_stages(service, subjects, out_dir)
    main_rec = k1[("bfloat16", N_MAIN)]
    emit({"kernels": [{
        "name": "fused_dual_mlp",
        "route": "cuda",
        "source": "surs_tpu_torch/csrc/fused_dual_mlp.cu",
        "replaces": "surs_tpu/ops/fused_mlp.py:228",
        "launches": serve["k1_launches"],
        "max_abs_err": max(k1[("bfloat16", N_MAIN)]["max_abs_err"],
                           k1[("bfloat16", N_MAIN - 1)]["max_abs_err"]),
        "ms": main_rec["ms"],
        "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"],
        "bound_by": main_rec["bound_by"],
        "library_ms": None,
    }]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
