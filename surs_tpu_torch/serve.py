"""Reconstruction service (counterpart of ``surs_tpu/serve.py``): the
model is built once, then (image, mask) pairs become OBJ mesh pairs.

    service = SuRSService(cfg)              # on CUDA; device="cpu" to opt out
    service.warmup((256, 256))
    paths = service.reconstruct(image_rgb, mask, "subject", out_dir)

The weights come from ``cfg.load_netG_checkpoint_path`` (a port
``netG_*`` file or a reference state dict, compat/torch_import.py), from
``params=`` (a Flax params tree, or the JAX service's ``{"params",
"batch_stats"}`` of a batch-norm model) or, with neither, at random from
``cfg.seed``. A batch-norm model serves with its running statistics; a
multi-view model (``num_views`` > 1) does not serve, as in the JAX
package.

Images are HxWx3 uint8/float arrays (masked and normalised to [-1, 1]
inside). Point queries go through kernel K1 (ops/fused_mlp.py) on the
card; ``use_octree=False`` scores the whole grid through kernel K3, and
``serve_octree_mode='runs'`` the octree's dirty z-windows through K4.
"""

from __future__ import annotations

import os
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from .compat.flax_import import load_flax_params
from .compat.torch_import import load_netG
from .config import SuRSConfig, resolve_config, resolve_device
from .models.surs_net import surs_net_from_config
from .recon.pipeline import build_reconstructor, eval_calibration


def normalize_image(image, mask) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """uint8/float image -> masked, [-1, 1]-normalised float32 NHWC."""
    arr = np.asarray(image, np.float32)
    if arr.max() > 1.5:
        arr = arr / 255.0
    arr = (arr - 0.5) / 0.5
    m = None
    if mask is not None:
        m = np.asarray(mask, np.float32)
        if m.max() > 1.5:
            m = m / 255.0
        if m.ndim == 2:
            m = m[..., None]
        arr = arr * m
    return arr[None], m


def _add_stats(into: dict, part: dict) -> None:
    """Add one subject's stats into ``into``: numbers summed, lists
    extended, anything else (the path names) replaced."""
    for k, v in part.items():
        if isinstance(v, list):
            into.setdefault(k, []).extend(v)
        elif isinstance(v, (int, float)):
            into[k] = into.get(k, 0) + v
        else:
            into[k] = v


class SuRSService:
    """``params``: optional Flax params tree (numpy leaves) of the JAX
    package's SuRSNet, or its variables ``{"params", "batch_stats"}``,
    loaded through the weight bridge; otherwise the
    weights come from ``cfg.load_netG_checkpoint_path`` through
    ``load_netG``, or at random from ``cfg.seed`` without one; giving
    both raises. ``device`` defaults to CUDA and raises when no GPU is
    present."""

    def __init__(self, cfg: SuRSConfig, params: Optional[Mapping] = None,
                 device=None):
        self.device = resolve_device(device)
        cfg = resolve_config(cfg, self.device)
        if params is not None and cfg.load_netG_checkpoint_path:
            raise ValueError("give params= or load_netG_checkpoint_path, "
                             "not both")
        # float32 means float32: cuDNN would otherwise run f32
        # convolutions in TF32, and the port's f32 products must match
        # the reference's
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.model = surs_net_from_config(cfg, self.device)
        # the weights load before the kernels' packed copies are made
        if params is not None:
            load_flax_params(self.model, params)
        else:
            load_netG(cfg, self.model)
        # K1's weights; dense serving takes kernel K3, runs-mode octree
        # serving kernel K4, where the calibration allows
        self.rec = build_reconstructor(cfg, self.model, self.device,
                                       cfg.serve_octree_mode)
        self.weights = self.rec.weights

    def _data(self, image, mask):
        img, m = normalize_image(image, mask)
        data = {"img_LR": img, "b_min": np.asarray(self.cfg.b_min),
                "b_max": np.asarray(self.cfg.b_max)}
        if m is not None and self.cfg.mask_prune:
            data["mask_LR"] = m
        return data

    def warmup(self, image_hw: Tuple[int, int]) -> float:
        """One throw-away reconstruction at an input shape (builds the
        kernel, warms cuDNN's algorithm choice); returns seconds."""
        t0 = time.time()
        img = np.zeros((image_hw[0], image_hw[1], 3), np.float32)
        with tempfile.TemporaryDirectory() as td:
            self.rec.gen_mesh(self.cfg, self._data(img, None),
                              os.path.join(td, "warmup.obj"))
        return time.time() - t0

    def reconstruct(self, image, mask, name: str, out_dir: str,
                    stats: Optional[dict] = None) -> Tuple[str, str]:
        """One subject -> (<name>_HR.obj, <name>_LR.obj) paths."""
        os.makedirs(out_dir, exist_ok=True)
        return self.rec.gen_mesh(self.cfg, self._data(image, mask),
                                 os.path.join(out_dir, name + ".obj"),
                                 stats)

    def reconstruct_many(self, items, out_dir: str,
                         pipeline: Optional[bool] = None,
                         stats: Optional[dict] = None,
                         writer_thread: bool = False, depth: int = 2):
        """``items`` iterates (image, mask, name); returns the (HR, LR)
        path pairs in order. ``pipeline`` (default: on at resolution
        >= 512) begins subject i+1 (encode and evaluation) before
        finishing subject i (extraction and OBJ writes).
        ``writer_thread`` runs the finish stage (extraction, copies,
        native writes, which release the GIL) on one worker thread,
        with at most ``depth`` subjects in flight beyond the one being
        begun; each subject then keeps its own ``stats``, added into
        ``stats`` on this thread once all are done. The results equal
        sequential :meth:`reconstruct` calls."""
        os.makedirs(out_dir, exist_ok=True)
        if pipeline is None:
            pipeline = self.cfg.resolution >= 512
        if not pipeline:
            return [self.reconstruct(image, mask, name, out_dir, stats)
                    for image, mask, name in items]

        def begin(image, mask, name, st=stats):
            return self.rec.gen_mesh_begin(
                self.cfg, self._data(image, mask),
                os.path.join(out_dir, name + ".obj"), st)

        if not writer_thread:
            results, pending = [], None
            for image, mask, name in items:
                work = begin(image, mask, name)
                if pending is not None:
                    results.append(pending())
                pending = work
            if pending is not None:
                results.append(pending())
            return results
        futures, parts = [], []
        with ThreadPoolExecutor(max_workers=1,
                                thread_name_prefix="surs-writer") as ex:
            for image, mask, name in items:
                parts.append(None if stats is None else {})
                futures.append(ex.submit(begin(image, mask, name,
                                               parts[-1])))
                if len(futures) > depth:
                    futures[len(futures) - 1 - depth].result()
            results = [f.result() for f in futures]
        for part in parts if stats is not None else ():
            _add_stats(stats, part)
        return results

    def fields(self, image, mask, stats: Optional[dict] = None):
        """Raw (sdf_hr, sdf_lr) [R, R, R] occupancy tensors of a
        subject."""
        data = self._data(image, mask)
        _, feats_lr, feat_hr = self.rec.encode(data["img_LR"])
        sdf_hr, sdf_lr, _ = self.rec.evaluate(
            feats_lr, feat_hr, eval_calibration(1), self.cfg.resolution,
            data["b_min"], data["b_max"], use_octree=self.cfg.use_octree,
            num_samples=self.cfg.num_samples,
            threshold=self.cfg.threshold,
            init_resolution=self.cfg.octree_init_resolution,
            silhouette=data.get("mask_LR"), stats=stats)
        return sdf_hr, sdf_lr
