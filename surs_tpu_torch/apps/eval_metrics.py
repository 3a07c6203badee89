"""Mesh-fidelity comparison: Chamfer / point-to-surface / projected
normal consistency between two directories of OBJ meshes (counterpart of
``apps/eval_metrics.py``, the same flags and printed lines, plus
``--device``).

  python -m surs_tpu_torch.apps.eval_metrics --pred ./results/exp \
      --gt ./gt_meshes --suffix _HR.obj --n_samples 10000 [--normals]

Matches files by the shared prefix before ``--suffix``; prints a line per
subject and the mean. ``--normals`` adds the projected-normal-map
L2 / cosine columns (renders both meshes with the rasterizer). Runs on
CUDA unless ``--device`` names another device; raises without a GPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pred", required=True)
    ap.add_argument("--gt", required=True)
    ap.add_argument("--suffix", default="_HR.obj")
    ap.add_argument("--gt_suffix", default=None,
                    help="defaults to --suffix")
    ap.add_argument("--n_samples", type=int, default=10000)
    ap.add_argument("--seed", type=int, default=1991)
    ap.add_argument("--normals", action="store_true",
                    help="also report projected-normal L2/cos")
    ap.add_argument("--normal_res", type=int, default=512)
    ap.add_argument("--device", default=None,
                    help="torch device; default CUDA")
    return ap


def main(argv=None) -> list:
    """Returns the rows printed: [chamfer, gt->pred, pred->gt(, normal
    l2, normal cos)] per subject."""
    from ..config import resolve_device
    from ..data.sampling import MeshData
    from ..recon.mesh_io import load_obj
    from ..utils.metrics import chamfer_distance, projected_normal_error

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    gt_suffix = args.gt_suffix or args.suffix
    preds = sorted(f for f in os.listdir(args.pred)
                   if f.endswith(args.suffix))
    rows = []
    for f in preds:
        name = f[: -len(args.suffix)]
        gt_path = os.path.join(args.gt, name + gt_suffix)
        if not os.path.isfile(gt_path):
            print(f"{name}: no GT mesh, skipped")
            continue
        pred_mesh = MeshData(*load_obj(os.path.join(args.pred, f)))
        gt_mesh = MeshData(*load_obj(gt_path))
        if pred_mesh.verts.shape[0] < 3 or gt_mesh.verts.shape[0] < 3:
            print(f"{name}: degenerate mesh, skipped")
            continue
        ch, p2g, g2p = chamfer_distance(gt_mesh, pred_mesh,
                                        n_samples=args.n_samples,
                                        seed=args.seed, device=device)
        line = (f"{name}: chamfer={ch:.5f}  gt->pred={p2g:.5f}  "
                f"pred->gt={g2p:.5f}")
        row = [ch, p2g, g2p]
        if args.normals:
            nl2, ncos = projected_normal_error(pred_mesh, gt_mesh,
                                               res=args.normal_res,
                                               device=device)
            line += f"  normal_l2={nl2:.4f}  normal_cos={ncos:.4f}"
            row += [nl2, ncos]
        rows.append(row)
        print(line)
    if rows:
        arr = np.asarray(rows)
        line = (f"MEAN over {len(rows)}: chamfer={arr[:,0].mean():.5f}  "
                f"gt->pred={arr[:,1].mean():.5f}  "
                f"pred->gt={arr[:,2].mean():.5f}")
        if args.normals:
            line += (f"  normal_l2={arr[:,3].mean():.4f}  "
                     f"normal_cos={arr[:,4].mean():.4f}")
        print(line)
    return rows


if __name__ == "__main__":
    main()
