"""Serve the port: watch a directory, reconstruct every new image
(the flags of ``apps/serve_surs.py``).

  python -m surs_tpu_torch --watch_dir ./incoming --name served \
      --resolution 512 --b_min -0.5 -0.5 -0.5 --b_max 0.5 0.5 0.5

``<name>.{jpg,png}`` + optional ``<name>_mask.png`` pairs become
``<results_path>/<name>/<name>_HR.obj`` / ``_LR.obj``. ``--once``
processes the current directory contents and exits. Runs on CUDA;
``--device cpu`` runs on the CPU instead. Images are decoded with PIL
where it is installed; without it only PNG files are read
(``data/png.py``: 8-bit gray, gray + alpha, RGB, RGBA), and a ``.jpg``
raises an error that names PIL. ``--mc_backend sharded`` extracts the
meshes in x-slabs over the ranks of the process group; under
``torchrun --nproc_per_node N -m surs_tpu_torch --mc_backend sharded``
every rank serves each image and rank 0 prints and writes.
"""

from __future__ import annotations

import os
import time

import torch.distributed as dist


def main(argv=None):
    from .config import (build_parser, config_from_args, resolve_config,
                         resolve_device)
    from .parallel.launch import distributed_run

    parser = build_parser()
    parser.add_argument("--watch_dir", required=True)
    parser.add_argument("--once", action="store_true")
    parser.add_argument("--poll_sec", type=float, default=1.0)
    parser.add_argument("--device", default=None)
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    device = resolve_device(args.device)
    distributed_run(resolve_config(cfg, device), device,
                    lambda root: _serve(args, cfg, device, root))


def _serve(args, cfg, device, root: bool):
    """The watch loop on one rank; ``root`` prints."""
    from .data.png import load_gray, load_rgb
    from .serve import SuRSService

    service = SuRSService(cfg, device=device)
    out_dir = os.path.join(cfg.results_path, cfg.name)
    done = set()
    if root:
        print("service ready; watching", args.watch_dir, flush=True)

    def load(name):
        img_path = None
        for ext in ("jpg", "png"):
            p = os.path.join(args.watch_dir, f"{name}.{ext}")
            if os.path.isfile(p):
                img_path = p
        mask_path = os.path.join(args.watch_dir, f"{name}_mask.png")
        mask = load_gray(mask_path) if os.path.isfile(mask_path) else None
        return load_rgb(img_path), mask

    while True:
        names = sorted(
            os.path.splitext(f)[0] for f in os.listdir(args.watch_dir)
            if f.lower().endswith((".jpg", ".png"))
            and not f.endswith("_mask.png"))
        if dist.is_initialized():
            # every rank serves rank 0's listing: the same collectives
            listing = [names]
            dist.broadcast_object_list(listing, src=0)
            names = listing[0]
        fresh = [n for n in names if n not in done]
        if fresh:
            t0 = time.time()
            pairs = service.reconstruct_many(
                ((*load(n), n) for n in fresh), out_dir)
            dt = (time.time() - t0) / len(fresh)
            for name, pair in zip(fresh, pairs):
                if root:
                    print(f"{name}: {dt:.2f}s/subject -> {pair[0]}",
                          flush=True)
                done.add(name)
        if args.once:
            break
        time.sleep(args.poll_sec)


if __name__ == "__main__":
    main()
