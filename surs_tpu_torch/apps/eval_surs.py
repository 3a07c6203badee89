"""Evaluate a trained model: one OBJ pair per test image (counterpart of
``apps/eval_surs.py``, the same flags, plus ``--device``).

  python -m surs_tpu_torch.apps.eval_surs --dataroot <dir> --name exp \
      --load_netG_checkpoint_path <ckpt> --resolution 512 \
      --b_min -0.5 -0.5 -0.5 --b_max 0.5 0.5 0.5

``<dataroot>/image_final/<name>.{jpg,png}`` with
``<dataroot>/mask_final/<name>.{png,jpg}`` (or ``--img_path`` /
``--mask_path``) become ``<results_path>/<name>/<image>_HR.obj`` and
``_LR.obj``. The checkpoint is a port ``netG_*`` file or a reference
state dict; without one the weights are random from ``--seed``. Runs on
CUDA and raises without a GPU; ``--device cpu`` runs on the CPU.
``--octree_mode`` picks the octree evaluator, as in the JAX CLI.
"""

from __future__ import annotations

import dataclasses
import os


def main(argv=None) -> None:
    from ..config import (build_parser, config_from_args, print_config,
                          resolve_config, resolve_device)
    from ..data.datasets import EvalDataset
    from ..serve import SuRSService

    parser = build_parser()
    parser.add_argument("--device", default=None,
                        help="torch device; default CUDA")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    cfg = resolve_config(config_from_args(args), device)
    # the eval CLI's octree evaluator is --octree_mode (the service's
    # knob is serve_octree_mode)
    cfg = dataclasses.replace(cfg, serve_octree_mode=cfg.octree_mode)
    print(print_config(cfg))

    dataset = EvalDataset(cfg)
    print("test data size:", len(dataset))
    service = SuRSService(cfg, device=device)

    out_dir = os.path.join(cfg.results_path, cfg.name)
    os.makedirs(out_dir, exist_ok=True)
    print("generate mesh (test) ...")
    for idx in range(len(dataset)):
        data = dataset[idx]
        save_path = os.path.join(out_dir, f"{data['name']}.obj")
        service.rec.gen_mesh(service.cfg, data, save_path)
        print("saved", save_path)


if __name__ == "__main__":
    main()
