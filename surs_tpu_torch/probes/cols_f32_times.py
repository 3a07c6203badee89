"""The float32 K1, K3 and K4 of a checkout, timed on the card at the
serving, dense and runs paths' shapes, and a float32 mono request.

    python surs_tpu_torch/probes/cols_f32_times.py [--root DIR] [--tag NAME]

builds ``fused_cols_mlp.cu`` and ``fused_dual_mlp.cu`` of the checkout at
DIR (default: this one) with its own build (``ops/cuda_build.py``) and
runs its ``fused_dual_mlp_cols`` / ``fused_dual_mlp_runs`` with float32
column weights (``prepare_cols_weights(dtype=torch.float32)``) and its
``fused_dual_mlp`` with float32 weights (``prepare_fused_weights``) of
the reference-width MLPs, seeded as ``chip_smoke.py``'s ``kernel_mlps``
(seed 3, weights x 3): K3 on a 1,024-column slice of the 512^3 grid and
on the whole grid (262,144 columns x 512 depths), K4 on one chunk of
32,768 windows x 8 depths, with the 512 grid's depth features of the
eval calibration; K1 on 50,000 points in the served (256, 65) split,
and the column-term pre-pass alone on the same features and depth. The
slice and K1 are held to the checkout's float32 plain versions (max
|difference| of both outputs). Times are CUDA events: the slice median
of 5, the chunk, K1 and the pre-pass of 20 after 2 warm-ups, the grid
one launch after none (20 s in the FMA first design). Then one
synthetic subject served at 512^3 by the checkout's ``SuRSService``
(``chip_smoke.py``'s full-width config, mono octree,
``feature_dtype="float32"``, seeded random weights) after a warm-up
request: its seconds by stage (host clock, each stage ending in a
synchronize), K1's launches and the peak memory. Prints one JSON line
(``--tag`` names the tree) beside the card's name and power limit. To
compare two trees on one card, unpack one under ``_proof/`` and run the
file once from each in turns (parent, change, change, parent). Run it as
a file, as ``--root`` imports that checkout's package. Needs a CUDA
device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 3
SLICE_COLS, DENSE_R, NWIN, ZB, N_K1 = 1024, 512, 32_768, 8, 50_000


def median_ms(fn, reps: int, warm: int) -> float:
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


def k1_times(fm, mlps, cw, features) -> dict:
    """The float32 K1 at N_K1 points against its plain version, timed,
    and the pre-pass alone on the same features and depth."""
    import torch
    fw = fm.prepare_fused_weights(*mlps, dtype=torch.float32)
    x_lr, x_hr = features(N_K1)
    kf = x_hr[:, 0].contiguous()
    parts = [x_lr, torch.cat([x_hr, kf[:, None]], 1)]
    hr, lr = fm.fused_dual_mlp(parts, fw)
    torch.cuda.synchronize()
    ref_hr, ref_lr = fm.fused_dual_mlp_ref(parts, fw)
    return {"k1_max_abs_err": max((hr - ref_hr).abs().max().item(),
                                  (lr - ref_lr).abs().max().item()),
            "k1_ms": median_ms(lambda: fm.fused_dual_mlp(parts, fw), 20, 2),
            "k1_cols_terms_ms": median_ms(
                lambda: fm.column_terms(x_lr, x_hr, kf, cw), 20, 2)}


def mono_request(torch) -> dict:
    """One subject served at 512^3, mono octree, float32 features: its
    seconds by stage, K1's launches, the peak memory."""
    from surs_tpu_torch.config import SuRSConfig
    from surs_tpu_torch.ops import fused_mlp as fm
    from surs_tpu_torch.recon.pipeline import eval_calibration
    from surs_tpu_torch.serve import SuRSService, normalize_image

    cfg = SuRSConfig(loadSize=512, hg_dim=256, num_stack_lr=3,
                     resolution=512, mask_prune=True, b_min=[-0.5] * 3,
                     b_max=[0.5] * 3, seed=SEED, feature_dtype="float32")
    service = SuRSService(cfg)
    S = 256
    rng = np.random.default_rng(SEED)
    img = (rng.random((S, S, 3)) * 255).astype(np.uint8)
    yy, xx = np.mgrid[:S, :S]
    mask = ((((xx - S / 2) / (0.22 * S)) ** 2
             + ((yy - S / 2) / (0.40 * S)) ** 2) < 1).astype(np.uint8) * 255
    arr, m = normalize_image(img, mask)
    cfg = service.cfg
    out = {}
    for rep in range(2):                  # a warm-up request, then timed
        t = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            t.append(time.perf_counter())

        torch.cuda.reset_peak_memory_stats()
        fm.fused_dual_mlp.launches = 0
        _, feats_lr, feat_hr = service.rec.encode(arr)
        mark()
        stats = {}
        sdf_hr, sdf_lr, mat = service.rec.evaluate(
            feats_lr, feat_hr, eval_calibration(1), cfg.resolution,
            cfg.b_min, cfg.b_max, use_octree=True,
            num_samples=cfg.num_samples, threshold=cfg.threshold,
            init_resolution=cfg.octree_init_resolution, silhouette=m,
            stats=stats)
        mark()
        list(service.rec.extract_pair(sdf_hr, sdf_lr, mat,
                                      mc_backend="device",
                                      mc_caps={"algorithm": "cubes"}))
        mark()
        d = np.diff(t)
        out = {"mono_f32_encode_s": d[0], "mono_f32_evaluate_s": d[1],
               "mono_f32_extract_s": d[2], "mono_f32_mode": stats["mode"],
               "mono_f32_queries": stats["queries"],
               "mono_f32_k1_launches": fm.fused_dual_mlp.launches,
               "mono_f32_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    return out


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    from surs_tpu_torch.models.layers import init_weights
    from surs_tpu_torch.models.surface_classifier import SurfaceClassifier
    from surs_tpu_torch.ops import cuda_build
    from surs_tpu_torch.ops import fused_mlp as fm
    from surs_tpu_torch.ops.geometry import normalize_depth, orthogonal
    from surs_tpu_torch.recon.grid import flat_index_to_world, grid_matrix
    from surs_tpu_torch.recon.pipeline import eval_calibration
    if not os.path.abspath(fm.__file__).startswith(root + os.sep):
        raise RuntimeError(f"surs_tpu_torch imported from outside {root}: "
                           "run this file as a script")
    if not torch.cuda.is_available():
        print("cols_f32_times: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_build.build(["fused_cols_mlp", "fused_dual_mlp"])

    gen = torch.Generator().manual_seed(SEED)
    mlps = [SurfaceClassifier(fm.KERNEL_DIMS_LR),
            SurfaceClassifier(fm.KERNEL_DIMS_HR)]
    for m in mlps:
        init_weights(m, gen)
        with torch.no_grad():
            for p in m.parameters():
                p.mul_(3.0)
    mlps = [m.cuda() for m in mlps]
    cw = fm.prepare_cols_weights(*mlps, 256, dtype=torch.float32)
    # the depth features of the eval calibration's 512^3 grid
    mat = grid_matrix((DENSE_R,) * 3, [-0.5] * 3, [0.5] * 3)
    pts = flat_index_to_world(torch.arange(DENSE_R).cuda(), DENSE_R, 1, mat)
    calib = torch.from_numpy(eval_calibration(1)).cuda()
    zf = normalize_depth(orthogonal(pts[None], calib)[0, 2, :], 512,
                         200.0).contiguous()
    rng = np.random.default_rng(SEED)

    def features(n):
        return tuple(torch.from_numpy(rng.standard_normal((n, c)).astype(
            np.float32)).cuda() for c in (256, 64))

    out = {"probe": "cols_f32_times", "tag": args.tag, "root": root}
    sl = (*features(SLICE_COLS), zf, cw)
    hr, lr = fm.fused_dual_mlp_cols(*sl)
    torch.cuda.synchronize()
    ref_hr, ref_lr = fm.fused_dual_mlp_cols_ref(*sl)
    out["k3_slice_max_abs_err"] = max((hr - ref_hr).abs().max().item(),
                                      (lr - ref_lr).abs().max().item())
    out["k3_slice_ms"] = median_ms(lambda: fm.fused_dual_mlp_cols(*sl), 5, 2)
    x_lr, x_hr = features(NWIN)
    k0 = torch.from_numpy(rng.integers(0, DENSE_R // ZB, NWIN) * ZB).cuda()
    runs = (x_lr, x_hr, (zf - zf[0])[k0].contiguous(), zf[:ZB].contiguous(),
            cw)
    out["k4_chunk_ms"] = median_ms(lambda: fm.fused_dual_mlp_runs(*runs),
                                   20, 2)
    grid = (*features(DENSE_R * DENSE_R), zf, cw)
    out["k3_grid_ms"] = median_ms(lambda: fm.fused_dual_mlp_cols(*grid), 1,
                                  0)
    del grid
    out.update(k1_times(fm, mlps, cw, features))
    out.update(mono_request(torch))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    out["card"] = card.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
