"""Render a training dataset (RENDER / MASK / PARAM) from GEO/OBJ meshes
(counterpart of ``apps/render_dataset.py``, the same flags, plus
``--device``).

  python -m surs_tpu_torch.apps.render_dataset --dataroot ./data \
      --loadSize 512 --yaw_step 1

Every ``<dataroot>/GEO/OBJ/<subject>_HR.obj`` is rendered by the port's
rasterizer on CUDA (``--device cpu`` to opt out; raises without a GPU).
``--uv`` also writes the color branch's UV-space renders (UV_RENDER /
UV_MASK / UV_POS / UV_NORMAL, ``render/uv.py``) at ``--uv_size``.
``--prt`` shades with per-vertex shadowed radiance transfer
(``render/prt.py``), computed on the same device and cached beside each
OBJ as ``<subject>_prt.npy``.
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataroot", required=True,
                    help="root containing GEO/OBJ/<subject>_HR.obj")
    ap.add_argument("--loadSize", type=int, default=512)
    ap.add_argument("--yaw_step", type=int, default=1)
    ap.add_argument("--patch", type=int, default=16,
                    help="rasterizer per-face patch (px)")
    ap.add_argument("--subjects", nargs="*", default=None)
    ap.add_argument("--prt", action="store_true",
                    help="shade with per-vertex precomputed radiance "
                         "transfer (the reference renderer's lighting "
                         "model) instead of analytic SH")
    ap.add_argument("--uv", action="store_true",
                    help="also render the UV-space color-supervision "
                         "layout (UV_RENDER/UV_MASK/UV_POS/UV_NORMAL)")
    ap.add_argument("--uv_size", type=int, default=512)
    ap.add_argument("--device", default=None,
                    help="torch device; default CUDA")
    return ap


def main(argv=None) -> None:
    from ..render import render_dataset, render_uv_dataset

    args = build_parser().parse_args(argv)
    obj_dir = os.path.join(args.dataroot, "GEO", "OBJ")
    render_dataset(obj_dir, args.dataroot, load_size=args.loadSize,
                   yaw_step=args.yaw_step, patch=args.patch,
                   subjects=args.subjects, use_prt=args.prt,
                   device=args.device)
    if args.uv:
        render_uv_dataset(obj_dir, args.dataroot, uv_size=args.uv_size,
                          yaw_step=args.yaw_step, subjects=args.subjects,
                          device=args.device)


if __name__ == "__main__":
    main()
