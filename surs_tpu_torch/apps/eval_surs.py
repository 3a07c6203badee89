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

``--mc_backend sharded`` extracts both meshes in x-slabs over the ranks
of the process group (``parallel/sharded_mc.py``): alone it is one rank;
under ``torchrun --nproc_per_node N -m surs_tpu_torch.apps.eval_surs
--mc_backend sharded ...`` every rank evaluates the subject (NCCL on the
cards) and meshes its slab, and rank 0 prints and writes the files. A
``torchrun`` launch takes no other backend.

``--with_color --load_netC_checkpoint_path <netC>`` also writes
``<image>_HR_color.obj``: the HR mesh read back from its file, each
vertex colored by the color net (``compat/torch_import.py:load_netC``: a
reference ResBlkPIFuNet state dict, which also samples netG's last lr
map, a port ResBlkColorNet state_dict or a JAX param tree), in float32
with TF32 off (``train/color.py``). ``--with_color`` without a netC
writes no color OBJ, as the JAX CLI, and says so.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional


def colorize_mesh(service, color_net, is_ref: bool, data: dict,
                  p_hr: str) -> Optional[dict]:
    """Color ``p_hr``'s vertices as read back from the file and write
    ``p_hr[:-4] + "_color.obj"``; returns {vertices, colorize_s,
    write_s}, or None for an empty mesh."""
    from ..recon.mesh_io import load_obj, save_obj_mesh_with_color
    from ..train.color import colorize_vertices, colorize_vertices_ref

    verts, faces = load_obj(p_hr)
    if verts.shape[0] == 0:
        print(f"empty HR mesh for {data['name']} — skip color")
        return None
    t0 = time.perf_counter()
    if is_ref:
        _, feats_lr, _ = service.rec.encode(data["img_LR"])
        rgb = colorize_vertices_ref(color_net, data["img_LR"], feats_lr[-1],
                                    verts, data["calib"])
    else:
        rgb = colorize_vertices(color_net, data["img_LR"], verts,
                                data["calib"])
    t1 = time.perf_counter()
    save_obj_mesh_with_color(p_hr[:-4] + "_color.obj", verts, faces, rgb)
    rec = {"vertices": int(verts.shape[0]), "colorize_s": t1 - t0,
           "write_s": time.perf_counter() - t1}
    print(f"color {data['name']}: {rec['vertices']} vertices, colorize "
          f"{rec['colorize_s']:.3f} s, write {rec['write_s']:.3f} s")
    return rec


def main(argv=None) -> None:
    from ..config import (build_parser, config_from_args, resolve_config,
                          resolve_device)
    from ..parallel.launch import distributed_run

    parser = build_parser()
    parser.add_argument("--device", default=None,
                        help="torch device; default CUDA")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    cfg = resolve_config(config_from_args(args), device)
    # the eval CLI's octree evaluator is --octree_mode (the service's
    # knob is serve_octree_mode)
    cfg = dataclasses.replace(cfg, serve_octree_mode=cfg.octree_mode)
    distributed_run(cfg, device, lambda root: _eval(cfg, device, root))


def _eval(cfg, device, root: bool) -> None:
    """The CLI's work on one rank; ``root`` prints and colors."""
    from ..compat.torch_import import load_netC
    from ..config import print_config
    from ..data.datasets import EvalDataset
    from ..serve import SuRSService

    def say(*args):
        if root:
            print(*args)

    say(print_config(cfg))

    dataset = EvalDataset(cfg)
    say("test data size:", len(dataset))
    service = SuRSService(cfg, device=device)
    color_net, is_ref = None, False
    if cfg.with_color:
        if cfg.load_netC_checkpoint_path:
            color_net, is_ref = load_netC(cfg, device)
        else:
            say("--with_color: no netC given (--load_netC_checkpoint_path)"
                "; no color OBJ is written")

    out_dir = os.path.join(cfg.results_path, cfg.name)
    os.makedirs(out_dir, exist_ok=True)
    say("generate mesh (test) ...")
    for idx in range(len(dataset)):
        data = dataset[idx]
        save_path = os.path.join(out_dir, f"{data['name']}.obj")
        p_hr, _ = service.rec.gen_mesh(service.cfg, data, save_path)
        if color_net is not None and root:
            colorize_mesh(service, color_net, is_ref, data, p_hr)
        say("saved", save_path)


if __name__ == "__main__":
    main()
