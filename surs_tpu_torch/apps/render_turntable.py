"""Turntable GIF of a reconstructed OBJ (counterpart of
``apps/render_turntable.py``, the same arguments, plus ``--device``).

  python -m surs_tpu_torch.apps.render_turntable result_HR.obj out.gif \
      --frames 36 --res 256

The frames render on CUDA unless ``--device`` names another device
(raises without a GPU); PIL writes the GIF.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("obj")
    ap.add_argument("gif")
    ap.add_argument("--frames", type=int, default=36)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="torch device; default CUDA")
    return ap


def main(argv=None) -> None:
    from ..render.turntable import turntable_gif

    args = build_parser().parse_args(argv)
    turntable_gif(args.obj, args.gif, n_frames=args.frames, res=args.res,
                  device=args.device)
    print("saved", args.gif)


if __name__ == "__main__":
    main()
