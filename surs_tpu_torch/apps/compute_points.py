"""Dataset sampling statistics (counterpart of ``apps/compute_points.py``,
the same flags and printed lines, plus ``--device``).

  python -m surs_tpu_torch.apps.compute_points --dataroot ./data \
      --num_sample_inout 6000

For each ``<dataroot>/GEO/OBJ/<subject>_{HR,LR}.obj`` pair it runs the
training sampler's HR / LR containment labelling and counts the
displacement labels that flip: LR-inside points outside the HR mesh and
LR-outside points inside it. The winding numbers run on CUDA (the
kernel ``csrc/winding_number.cu``) unless ``--device`` names another
device; raises without a GPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataroot", required=True)
    ap.add_argument("--num_sample_inout", type=int, default=6000)
    ap.add_argument("--sigma", type=float, default=0.06)
    ap.add_argument("--b_min", nargs=3, type=float,
                    default=[-128.0, -28.0, -128.0])
    ap.add_argument("--b_max", nargs=3, type=float,
                    default=[128.0, 228.0, 128.0])
    ap.add_argument("--limit", type=int, default=0,
                    help="max subjects (0 = all)")
    ap.add_argument("--seed", type=int, default=1991)
    ap.add_argument("--device", default=None,
                    help="torch device; default CUDA")
    return ap


def main(argv=None) -> dict:
    """Print a line a subject and the total; returns the counts
    {subject: (LR-in/HR-out, LR-out/HR-in, points)}."""
    from ..config import resolve_device
    from ..data.sampling import MeshData, sample_points_and_labels
    from ..recon.mesh_io import load_obj

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    obj_dir = os.path.join(args.dataroot, "GEO", "OBJ")
    subjects = sorted({f[:-7] for f in os.listdir(obj_dir)
                       if f.endswith("_HR.obj")})
    if args.limit:
        subjects = subjects[:args.limit]

    counts = {}
    total_flips_in = total_flips_out = total = 0
    for subject in subjects:
        mesh_hr = MeshData(*load_obj(
            os.path.join(obj_dir, subject + "_HR.obj")))
        mesh_lr = MeshData(*load_obj(
            os.path.join(obj_dir, subject + "_LR.obj")))
        rng = np.random.default_rng(args.seed)
        out = sample_points_and_labels(
            mesh_hr, mesh_lr, args.num_sample_inout, args.sigma,
            np.asarray(args.b_min), np.asarray(args.b_max), rng,
            device=device)
        n = out["labels_disp"].shape[1]
        half = n // 2
        # the first half of samples_LR is LR-inside: a displacement label
        # 0 there is a point outside HR (erosion); a 1 in the second half
        # an LR-outside point inside HR (dilation)
        flips_in = int((out["labels_disp"][0, :half] == 0).sum())
        flips_out = int((out["labels_disp"][0, half:] == 1).sum())
        total_flips_in += flips_in
        total_flips_out += flips_out
        total += n
        counts[subject] = (flips_in, flips_out, n)
        print(f"{subject}: LR-in/HR-out={flips_in}  "
              f"LR-out/HR-in={flips_out}  of {n}")
    if total:
        print(f"TOTAL: {total_flips_in + total_flips_out}/{total} "
              f"displaced ({100.0 * (total_flips_in + total_flips_out) / total:.2f}%)")
    return counts


if __name__ == "__main__":
    main()
