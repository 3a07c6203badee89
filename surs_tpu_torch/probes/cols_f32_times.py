"""The float32 K3 and K4 of a checkout, timed on the card at the dense and
runs paths' shapes.

    python surs_tpu_torch/probes/cols_f32_times.py [--root DIR] [--tag NAME]

builds ``surs_tpu_torch/csrc/fused_cols_mlp.cu`` of the checkout at DIR
(default: this one) with its own build (``ops/cuda_build.py``) and runs
its ``fused_dual_mlp_cols`` / ``fused_dual_mlp_runs`` with float32 column
weights (``prepare_cols_weights(dtype=torch.float32)``) of the
reference-width MLPs, seeded as ``chip_smoke.py``'s ``kernel_mlps``
(seed 3, weights x 3): K3 on a 1,024-column slice of the 512^3 grid and
on the whole grid (262,144 columns x 512 depths), K4 on one chunk of
32,768 windows x 8 depths, with the 512 grid's depth features of the
eval calibration. The slice is held to the checkout's float32 plain
version (max |difference| of both outputs). Times are CUDA events: the
slice median of 5 and the chunk of 20 after 2 warm-ups, the grid one
launch after none (20 s in the FMA first design). Prints one JSON line
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

import numpy as np

SEED = 3
SLICE_COLS, DENSE_R, NWIN, ZB = 1024, 512, 32_768, 8


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
    cuda_build.build(["fused_cols_mlp"])

    gen = torch.Generator().manual_seed(SEED)
    mlps = [SurfaceClassifier(fm.KERNEL_DIMS_LR),
            SurfaceClassifier(fm.KERNEL_DIMS_HR)]
    for m in mlps:
        init_weights(m, gen)
        with torch.no_grad():
            for p in m.parameters():
                p.mul_(3.0)
    cw = fm.prepare_cols_weights(*(m.cuda() for m in mlps), 256,
                                 dtype=torch.float32)
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
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    out["card"] = card.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
