"""The accuracy loop at the reference operating point: a synthetic
humanoid is rendered, trained on, reconstructed and scored (the port's
counterpart of the training and scoring part of
``benchmarks/subject_demo.py``).

  python -m surs_tpu_torch.probes.subject_demo [--iters 1500] \
      [--out result.json] [--device cpu] [--dtype float32]

1. The subject: the capsule humanoid (``utils/synth.py``), HR with a
   0.012 surface detail and a smooth LR, meshed by the port's marching
   tetrahedra on ``humanoid_volume`` at 160^3 over [-0.85, 1.0]^3, as
   the JAX demo meshes it (``benchmarks/subject_demo.py:74-83``).
2. The dataset: 12 yaws (every 30 degrees) rendered at loadSize 512 by
   the port's renderer, and a sample cache of 16 draws with exact
   implicit labels (``humanoid_sdf_np`` < 0, no mesh containment).
3. Training through ``train(cfg, max_iters=..., yaw_list=...)`` at full
   width: residual SR, 3 lr stacks, ``--fused_train`` (kernel K2),
   learning rate 4e-4, batch 2, 6,000 points, box +-1. The yaw list holds
   the 12 yaws repeated so that one epoch spans the run (the trainer
   saves a 0.25 GB checkpoint at every epoch end).
4. A 512^3 mono reconstruction of view 0 with silhouette pruning through
   kernel K1, with the item's own calibration, meshed by marching cubes
   on the card as the JAX demo's reconstruction is, timed by stage
   (encode, evaluate, extract, write) and as one request.
5. Chamfer, point-to-surface and normal L2 / cosine of the HR mesh
   against the HR ground truth (``utils/metrics.py``), for the trained
   weights and for the same pipeline at step 0 (the seed's weights).

Prints one JSON object as its last line. Runs on CUDA unless ``--device``
names another device; raises without a GPU. ``chip_smoke.py``'s
``accuracy`` phase runs the same functions with fewer steps.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch

HR_DETAIL = 0.012
GT_RES = 160
GT_LO, GT_HI = -0.85, 1.0
YAWS = list(range(0, 360, 30))
N_INOUT = 6000
SIGMA = 0.025
DRAWS = 16
ITERS = 1500
SUBJECT = "h0"
METRIC_SAMPLES = 4000
P2S_SURFACE = 50000


def humanoid_mesh(detail: float, resolution: int = GT_RES, device=None):
    """(verts [V, 3] float32 world, faces [F, 3] int64) numpy: marching
    tetrahedra of ``humanoid_volume`` at level 0.5 over [GT_LO, GT_HI]^3
    on ``device``, as the JAX demo meshes it."""
    from ..recon.tetra import marching_tetrahedra
    from ..utils.synth import humanoid_volume

    vol = humanoid_volume(resolution, detail, GT_LO, GT_HI, device=device)
    verts, faces = marching_tetrahedra(vol, 0.5)
    verts = GT_LO + verts.double() * ((GT_HI - GT_LO) / (resolution - 1))
    return verts.float().cpu().numpy(), faces.cpu().numpy()


def write_subject(root: str, load_size: int = 512, gt_res: int = GT_RES,
                  n_inout: int = N_INOUT, draws: int = DRAWS,
                  device=None) -> Dict:
    """Write the subject's dataset under ``root``: GEO/OBJ/h0_{HR,LR}.obj,
    RENDER / MASK / PARAM for ``YAWS`` at ``load_size`` and
    SAMPLE_CACHE/h0_<d>.npz; returns the seconds of each part and the
    meshes' faces."""
    from ..data.sampling import MeshData, sample_points_and_labels
    from ..recon.mesh_io import load_obj, save_obj_mesh
    from ..render import render_dataset
    from ..utils.synth import humanoid_sdf_np

    rec = {}
    obj_dir = os.path.join(root, "GEO", "OBJ")
    os.makedirs(obj_dir, exist_ok=True)
    t0 = time.perf_counter()
    for tag, detail in (("HR", HR_DETAIL), ("LR", 0.0)):
        verts, faces = humanoid_mesh(detail, gt_res, device)
        save_obj_mesh(os.path.join(obj_dir, f"{SUBJECT}_{tag}.obj"), verts,
                      faces)
        rec[f"faces_{tag.lower()}_gt"] = int(faces.shape[0])
    with open(os.path.join(root, "val.txt"), "w"):
        pass
    rec["gt_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    render_dataset(obj_dir, root, load_size=load_size,
                   yaw_step=360 // len(YAWS), patch=16, device=device)
    rec["render_s"] = time.perf_counter() - t0

    # the sample cache, labelled by the implicit itself
    t0 = time.perf_counter()
    cache_dir = os.path.join(root, "SAMPLE_CACHE")
    os.makedirs(cache_dir, exist_ok=True)
    mesh_hr = MeshData(*load_obj(os.path.join(obj_dir, f"{SUBJECT}_HR.obj")))
    mesh_lr = MeshData(*load_obj(os.path.join(obj_dir, f"{SUBJECT}_LR.obj")))

    def contains_fn(pts, m):
        detail = HR_DETAIL if m is mesh_hr else 0.0
        return humanoid_sdf_np(np.asarray(pts, np.float32),
                               detail=detail) < 0

    for d in range(draws):
        out = sample_points_and_labels(
            mesh_hr, mesh_lr, n_inout, SIGMA, np.array([-1.0] * 3),
            np.array([1.0] * 3), np.random.default_rng(1000 + d),
            contains_fn=contains_fn)
        np.savez_compressed(os.path.join(cache_dir,
                                         f"{SUBJECT}_{d:03d}.npz"), **out)
    rec["cache_s"] = time.perf_counter() - t0
    return rec


def subject_config(root: str, work_dir: str, load_size: int = 512,
                   iters: int = ITERS, **kw):
    """The demo's training and serving configuration (full width)."""
    from ..config import SuRSConfig

    base = dict(dataroot=root, name="subject", loadSize=load_size,
                residual=True, num_sample_inout=N_INOUT, sigma=SIGMA,
                batch_size=2, num_stack_lr=3, learning_rate=4e-4,
                resolution=512, octree_init_resolution=64, mask_prune=True,
                b_min=[-1.0] * 3, b_max=[1.0] * 3, fused_train=True,
                no_gen_mesh=True, freq_save=iters + 1, freq_save_ply=0,
                checkpoints_path=os.path.join(work_dir, "checkpoints"),
                results_path=os.path.join(work_dir, "results"))
    return SuRSConfig(**{**base, **kw})


def train_subject(cfg, iters: int, device=None) -> Dict:
    """Train ``cfg`` for ``iters`` steps on the subject's 12 views;
    returns {"model", "losses" (every step's total loss), "summary"
    (train()'s), "seconds_per_step"}."""
    from ..train.loop import train

    losses, model = [], []

    def on_step(state, metrics):
        losses.append(metrics["total"].detach())
        if not model:
            model.append(state.model)

    repeat = -(-iters * cfg.batch_size // len(YAWS))
    summary = train(cfg, max_iters=iters, device=device, on_step=on_step,
                    yaw_list=YAWS * repeat)
    return {"model": model[0], "losses": [float(x) for x in losses],
            "summary": summary,
            "seconds_per_step": summary["wall_sec"] / max(summary["iters"],
                                                          1)}


def view_item(cfg, device=None) -> Dict:
    """View 0 of the subject as ``gen_mesh`` takes it: the LR image and
    mask, the item's calibration and the box."""
    from ..data.datasets import TrainDataset

    item = TrainDataset(cfg, "test", yaw_list=[0],
                        contains_device=device).get_item(0)
    return {"img_LR": np.asarray(item["img_LR"])[None],
            "mask_LR": np.asarray(item["mask_LR"]),
            "calib": np.asarray(item["calib"]).reshape(1, 4, 4),
            "b_min": np.asarray(item["b_min"]),
            "b_max": np.asarray(item["b_max"])}


def reconstruct(cfg, model, data: Dict, out_dir: str, device,
                stages: bool = True, on_fields=None) -> Dict:
    """The 512^3 mono reconstruction of ``data`` through kernel K1.
    With ``stages``: one warm-up request, then the stages (each ending in
    a synchronize) and one timed request. Returns the HR mesh
    (``verts``, ``faces``) and the times; ``on_fields(sdf_hr, sdf_lr)``,
    if given, sees the evaluated fields after the extract stage and
    returns a dict kept under ``"fields"``."""
    from ..recon.mesh_io import save_obj_mesh
    from ..recon.pipeline import build_reconstructor

    device = torch.device(device)
    rec = build_reconstructor(cfg, model, device, cfg.serve_octree_mode)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    out = {}
    if stages:
        rec.gen_mesh(cfg, data, os.path.join(out_dir, "warmup.obj"))
    t = [time.perf_counter()]

    def mark():
        sync()
        t.append(time.perf_counter())

    _, feats_lr, feat_hr = rec.encode(data["img_LR"])
    mark()
    stats = {}
    sdf_hr, sdf_lr, mat = rec.evaluate(
        feats_lr, feat_hr, data["calib"], cfg.resolution, data["b_min"],
        data["b_max"], use_octree=cfg.use_octree,
        num_samples=cfg.num_samples, threshold=cfg.threshold,
        init_resolution=cfg.octree_init_resolution,
        silhouette=data["mask_LR"], stats=stats)
    mark()
    meshes = list(rec.extract_pair(sdf_hr, sdf_lr, mat, mc_backend="device",
                                   mc_caps={"algorithm": "cubes"}))
    mark()
    if on_fields is not None:
        out["fields"] = on_fields(sdf_hr, sdf_lr)
    del sdf_hr, sdf_lr, feats_lr, feat_hr
    if stages:
        t0 = time.perf_counter()
        for name, (v, f) in zip(("HR", "LR"), meshes):
            save_obj_mesh(os.path.join(out_dir, f"stages_{name}.obj"), v, f)
        d = np.diff(t)
        out.update(encode_s=d[0], evaluate_s=d[1], extract_s=d[2],
                   write_s=time.perf_counter() - t0, mode=stats["mode"],
                   queries=stats["queries"])
        t0 = time.perf_counter()
        rec.gen_mesh(cfg, data, os.path.join(out_dir, "request.obj"))
        sync()
        out["request_s"] = time.perf_counter() - t0
    (verts, faces), (_, faces_lr) = meshes
    out.update(verts=verts, faces=faces, faces_hr=int(faces.shape[0]),
               faces_lr=int(faces_lr.shape[0]))
    return out


def score(verts: np.ndarray, faces: np.ndarray, root: str, calib,
          device, normals: bool = True) -> Dict:
    """Chamfer (gt->rec, rec->gt), P2S and the projected normal error of
    a reconstructed HR mesh against the subject's HR ground truth, as
    ``benchmarks/subject_demo.py`` scores it. An empty mesh scores
    Chamfer = inf."""
    from ..data.sampling import MeshData
    from ..recon.mesh_io import load_obj
    from ..utils.metrics import (chamfer_distance, point_to_surface,
                                 projected_normal_error)

    if faces.shape[0] == 0:
        return {"chamfer": float("inf"), "empty": True}
    mesh_hr = MeshData(*load_obj(os.path.join(root, "GEO", "OBJ",
                                              f"{SUBJECT}_HR.obj")))
    rec_mesh = MeshData(np.asarray(verts, np.float32), faces)
    out = {}
    t0 = time.perf_counter()
    ch, ab, ba = chamfer_distance(mesh_hr, rec_mesh,
                                  n_samples=METRIC_SAMPLES, device=device)
    out.update(chamfer=ch, chamfer_gt_to_rec=ab, chamfer_rec_to_gt=ba,
               chamfer_pct_of_scale=100 * ch / 1.7)
    if normals:
        pick = np.random.default_rng(0).choice(
            verts.shape[0], min(METRIC_SAMPLES, verts.shape[0]),
            replace=False)
        out["p2s"] = point_to_surface(verts[pick], mesh_hr,
                                      n_surface=P2S_SURFACE, device=device)
        # the OBJ writer's 'f v0 v2 v1' winding comes back reversed from
        # the file: flip the ground truth back to the extractor's
        # orientation, which the in-memory reconstruction keeps
        gt = MeshData(mesh_hr.verts, mesh_hr.faces[:, ::-1].copy())
        out["normal_l2"], out["normal_cos"] = projected_normal_error(
            rec_mesh, gt, calib=np.asarray(calib).reshape(4, 4), res=512,
            device=device)
    out["score_s"] = time.perf_counter() - t0
    return out


def run(iters: int = ITERS, device=None, work_dir: Optional[str] = None,
        load_size: int = 512, gt_res: int = GT_RES, draws: int = DRAWS,
        n_inout: int = N_INOUT, on_fields=None, **cfg_kw) -> Dict:
    """The whole loop; returns the record the probe prints.
    ``on_fields`` is :func:`reconstruct`'s, for the trained weights."""
    from ..config import resolve_config, resolve_device
    from ..models.surs_net import surs_net_from_config

    device = resolve_device(device)
    with tempfile.TemporaryDirectory(dir=work_dir) as tmp:
        root = os.path.join(tmp, "data")
        record = {"source": "surs_tpu_torch/probes/subject_demo.py",
                  "device": (torch.cuda.get_device_name(0)
                             if device.type == "cuda" else str(device)),
                  "iters": iters}
        record.update(write_subject(root, load_size, gt_res, n_inout,
                                    draws, device))
        cfg = resolve_config(subject_config(
            root, tmp, load_size, iters, num_sample_inout=n_inout, **cfg_kw),
            device)
        record.update(load_size=cfg.loadSize, resolution=cfg.resolution,
                      num_stack_lr=cfg.num_stack_lr, dtype=cfg.dtype,
                      feature_dtype=cfg.feature_dtype)
        data = view_item(cfg, device)
        # step 0: the seed's weights, which train() starts from
        untrained = surs_net_from_config(cfg, device)
        step0 = reconstruct(cfg, untrained, data, tmp, device, stages=False)
        record["step0"] = {"faces_hr": step0["faces_hr"], **score(
            step0["verts"], step0["faces"], root, data["calib"], device,
            normals=False)}
        del untrained, step0
        trained = train_subject(cfg, iters, device)
        losses = trained["losses"]
        record.update(loss_first=losses[0], loss_last=losses[-1],
                      loss_first10=float(np.mean(losses[:10])),
                      loss_last10=float(np.mean(losses[-10:])),
                      seconds_per_step=trained["seconds_per_step"],
                      train_s=trained["summary"]["wall_sec"])
        got = reconstruct(cfg, trained["model"], data, tmp, device,
                          on_fields=on_fields)
        record.update({k: v for k, v in got.items()
                       if k not in ("verts", "faces")})
        record.update(score(got["verts"], got["faces"], root, data["calib"],
                            device))
    return record


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--device", default=None,
                    help="torch device; default CUDA")
    ap.add_argument("--dtype", default=None,
                    choices=("float32", "bfloat16"),
                    help="the trunk's dtype; default the device's auto "
                    "(bfloat16 on CUDA; the JAX demo pins float32)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    record = run(args.iters, args.device,
                 **({"dtype": args.dtype} if args.dtype else {}))
    line = json.dumps(record)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return record


if __name__ == "__main__":
    main()
