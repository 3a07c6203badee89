"""Precompute training point samples and occupancy labels to disk
(counterpart of ``apps/precompute_samples.py``, the same flags, seeds
and ``.npz`` keys, plus ``--device``).

  python -m surs_tpu_torch.apps.precompute_samples --dataroot ./data \
      --num_sample_inout 6000 --sigma 5.0 --draws 20

For every subject of ``<dataroot>/GEO/OBJ`` (``<subject>_HR.obj`` with
its ``_LR.obj``), ``--draws`` independent draws of
``data.sampling.sample_points_and_labels``, draw d of subject si from
``default_rng(seed + d * 100003 + si)``, each written to
``<out>/<subject>_<d:03d>.npz`` (samples_HR, samples_LR, labels_HR,
labels_disp); a draw already on disk is kept. ``TrainDataset`` picks a
random cached draw for each item. The containment runs on CUDA unless
``--device`` names another device, and raises without a GPU.
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataroot", required=True)
    ap.add_argument("--out", default=None,
                    help="default <dataroot>/SAMPLE_CACHE")
    ap.add_argument("--num_sample_inout", type=int, default=6000)
    ap.add_argument("--sigma", type=float, default=0.06)
    ap.add_argument("--draws", type=int, default=20,
                    help="independent sample draws cached per subject")
    ap.add_argument("--b_min", nargs=3, type=float,
                    default=[-128.0, -28.0, -128.0])
    ap.add_argument("--b_max", nargs=3, type=float,
                    default=[128.0, 228.0, 128.0])
    ap.add_argument("--seed", type=int, default=1991)
    ap.add_argument("--device", default=None,
                    help="torch device of the containment; default CUDA")
    return ap


def main(argv=None) -> int:
    """Returns the number of draws written."""
    import numpy as np

    from ..config import resolve_device
    from ..data.sampling import MeshData, sample_points_and_labels
    from ..recon.mesh_io import load_obj

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    obj_dir = os.path.join(args.dataroot, "GEO", "OBJ")
    out_dir = args.out or os.path.join(args.dataroot, "SAMPLE_CACHE")
    os.makedirs(out_dir, exist_ok=True)

    subjects = sorted({f[:-7] for f in os.listdir(obj_dir)
                       if f.endswith("_HR.obj")})
    print(f"{len(subjects)} subjects -> {out_dir}")
    written = 0
    for si, subject in enumerate(subjects):
        mesh_hr = MeshData(*load_obj(os.path.join(obj_dir,
                                                  subject + "_HR.obj")))
        mesh_lr = MeshData(*load_obj(os.path.join(obj_dir,
                                                  subject + "_LR.obj")))
        for d in range(args.draws):
            path = os.path.join(out_dir, f"{subject}_{d:03d}.npz")
            if os.path.exists(path):
                continue
            rng = np.random.default_rng(args.seed + d * 100003 + si)
            out = sample_points_and_labels(
                mesh_hr, mesh_lr, args.num_sample_inout, args.sigma,
                np.asarray(args.b_min), np.asarray(args.b_max), rng,
                device=device)
            np.savez_compressed(path, **out)
            written += 1
        print(f"[{si + 1}/{len(subjects)}] {subject}")
    return written


if __name__ == "__main__":
    main()
