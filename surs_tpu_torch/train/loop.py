"""Training loop driver (counterpart of ``surs_tpu/train/loop.py``).

``train(cfg)`` builds the train and test ``TrainDataset`` of
``cfg.dataroot`` and their ``DataLoader`` (before the model, so that
worker processes fork without a CUDA context), then the model and
optimizer; resumes as the reference does (including its inverted
``continue_train == 0`` convention), and runs the epochs: the lagged
loss/ETA log line, checkpoints every ``freq_save`` iterations and at each
epoch end, the PLY dumps every ``freq_save_ply`` iterations, the
epoch-boundary LR step decay and the per-epoch meshes of the first
``num_gen_mesh_test`` test items and train items (the latter without
augmentation).

The sample labels' containment runs where the items are built: with
``num_workers == 0`` on the training device (in the loader's prefetch
thread, on a stream of its own), with worker processes on the CPU,
which is printed (the workers hide the GPUs).

A ``loader`` may be passed instead: any iterable with ``len`` of
collated batches in the training dataset's item format (``img_LR``
[B, S, S, 3], ``img_HR`` [B, 2S, 2S, 3], ``calib`` [B, 4, 4],
``samples_LR`` / ``samples_HR`` [B, 3, N], ``labels_disp`` /
``labels_HR`` [B, 1, N]); the epoch meshes then need ``gen_items`` or
``no_gen_mesh``.

``cfg.profile_dir`` records a ``torch.profiler`` trace
(``utils/profiling.Profiler``) from the epochs' start to the return. An
iteration's phases are spans (``utils/profiling.annotate``), regions of
that trace: ``surs.train.data_wait`` (the next batch from the loader),
``surs.train.h2d`` (the batch's host arrays and their copies to the
device), ``surs.train.step`` (the step call, with ``step.make_step``'s
phases inside), ``surs.train.log`` (the lagged loss line, whose read of
the loss is a ``surs.sync``), ``surs.train.checkpoint`` and
``surs.train.ply``; ``train()``'s summary sums their seconds.

``--fused_train`` on CUDA takes the fused step (kernel K2) unless the
model has batch norms or more than one view, as in the JAX package; every
other case, the CPU included, takes the plain step. The JAX package's packed
host-to-device transfer (``pack_h2d``) is a TPU-link measure and is not
carried over.
"""

from __future__ import annotations

import itertools
import os
import time
from typing import Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from ..config import SuRSConfig, resolve_config, resolve_device
from ..data.datasets import TrainDataset
from ..data.loader import DataLoader
from ..models.surs_net import surs_net_from_config
from ..ops.fused_mlp import prepare_fused_weights
from ..recon.mesh_io import save_samples_truncted_prob
from ..recon.pipeline import Reconstructor
from ..utils.profiling import Profiler, annotate, host_wait
from .checkpoint import CheckpointManager
from .optim import lr_for_epoch, make_optimizer, set_learning_rate
from .step import create_train_state, make_train_step

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def batch_host_arrays(batch: Mapping, quantize_images: bool = False
                      ) -> Dict[str, np.ndarray]:
    """Dataset keys -> model kwargs as host numpy arrays, labels as
    [B, N, 1]. Multi-view batches ([B, V, ...]) collapse images and
    calibs to [B*V, ...] and repeat the sample points per view.

    ``quantize_images`` ships images as uint8 (4x fewer bytes to the
    card); the train steps map them back. k = round(x * 127) + 127 is
    exact at -1, 0 (masked background) and +1 and within 1/254
    elsewhere."""
    img_lr = np.asarray(batch["img_LR"])
    img_hr = np.asarray(batch["img_HR"])
    if quantize_images:
        img_lr = np.clip(np.rint(img_lr * 127.0) + 127.0, 0,
                         254).astype(np.uint8)
        img_hr = np.clip(np.rint(img_hr * 127.0) + 127.0, 0,
                         254).astype(np.uint8)
    calib = np.asarray(batch["calib"])
    pts_lr = np.asarray(batch["samples_LR"])
    pts_hr = np.asarray(batch["samples_HR"])
    if img_lr.ndim == 5:                     # [B, V, H, W, C]
        V = img_lr.shape[1]
        img_lr = img_lr.reshape((-1,) + img_lr.shape[2:])
        img_hr = img_hr.reshape((-1,) + img_hr.shape[2:])
        calib = calib.reshape((-1,) + calib.shape[2:])
        pts_lr = np.repeat(pts_lr, V, axis=0)
        pts_hr = np.repeat(pts_hr, V, axis=0)
    return {
        "images_lr": img_lr,
        "images_hr": img_hr,
        "points_lr": pts_lr,
        "points_hr": pts_hr,
        "calibs": calib,
        "labels_lr": np.swapaxes(batch["labels_disp"], 1, 2),
        "labels_hr": np.swapaxes(batch["labels_HR"], 1, 2),
    }


def _to_device(host: Mapping[str, np.ndarray], device
               ) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in host.items()}


def batch_to_device(batch: Mapping, device, quantize_images: bool = False
                    ) -> Dict[str, torch.Tensor]:
    """:func:`batch_host_arrays` as tensors on ``device``."""
    return _to_device(batch_host_arrays(batch, quantize_images), device)


def fused_step_applies(cfg, device) -> bool:
    """Whether train() takes the fused step (K2): ``--fused_train`` on
    CUDA for a group-norm, single-view model, the JAX loop's conditions
    (``surs_tpu/train/loop.py:116-118``); else the plain step."""
    return (cfg.fused_train and cfg.norm != "batch" and cfg.num_views == 1
            and torch.device(device).type == "cuda")


def _gen_meshes(cfg, model, device, gen_items, epoch: int) -> None:
    """The epoch's meshes of the first ``num_gen_mesh_test`` items of
    each phase, through the serving pipeline (kernel K1 on the card);
    the eval encode normalises with the running statistics of a
    batch-norm model. A multi-view model raises here, after the epoch's
    checkpoint, as the JAX package fails in its epoch meshes."""
    dtype = _DTYPES[cfg.feature_dtype]
    rec = Reconstructor(model, prepare_fused_weights(
        model.mlp_lr, model.mlp_hr, dtype=dtype), device,
        feature_dtype=dtype)
    for phase in ("test", "train"):
        print(f"generate mesh ({phase}) ...")
        for data in list(gen_items.get(phase, ()))[:cfg.num_gen_mesh_test]:
            data = {**data, "img_LR": np.asarray(data["img_LR"])[None]}
            rec.gen_mesh(cfg, data, os.path.join(
                cfg.results_path, cfg.name,
                f"{phase}_eval_epoch{epoch}_{data['name']}.obj"))


def _dataset_gen_items(cfg, train_dataset: TrainDataset,
                       test_dataset: TrainDataset) -> Dict[str, list]:
    """The epoch meshes' items: the first ``num_gen_mesh_test`` test
    items, and as many train items built without augmentation
    (``surs_tpu/train/loop.py:248-273``)."""
    n = cfg.num_gen_mesh_test
    items = {"test": [test_dataset[i] for i in range(n)]}
    train_dataset.is_train = False
    try:
        items["train"] = [train_dataset[i] for i in range(n)]
    finally:
        train_dataset.is_train = True
    return items


def train(cfg: SuRSConfig, loader=None, max_iters: Optional[int] = None,
          device=None,
          gen_items: Optional[Mapping[str, Sequence[Mapping]]] = None,
          on_step: Optional[Callable] = None, yaw_list=None) -> Dict:
    """Train ``cfg``'s model; returns a wall-time summary: iterations,
    wall seconds, and the host seconds of the loop's spans: waiting for
    data (``data_sec``), in the step call (``enqueue_sec``; the card may
    still be running it), saving checkpoints (``save_sec``), logging
    (``log_sec``), preparing batches (``prep_sec``) and writing PLYs
    (``ply_sec``).

    ``loader``: None builds the datasets of ``cfg.dataroot`` (views
    ``yaw_list``, default every degree) and their loader; else an
    iterable of collated batches. ``device``: CUDA unless named
    (``"cpu"`` to opt out); raises when no GPU is present. ``gen_items``:
    {"test": [...], "train": [...]} items (``img_LR`` [S, S, 3],
    ``calib``, ``b_min``, ``b_max``, ``name``, optionally ``mask_LR``)
    for the per-epoch meshes; by default the datasets' (with a
    ``loader``: ``cfg.no_gen_mesh`` must then be set). ``on_step``:
    called as ``on_step(state, metrics)`` after every step."""
    t_train0 = time.time()
    device = resolve_device(device)
    cfg = resolve_config(cfg, device)
    if loader is not None:
        if not cfg.no_gen_mesh and gen_items is None:
            raise ValueError("per-epoch meshes from a given loader need "
                             "gen_items= (or set no_gen_mesh)")
        return _run(cfg, loader, max_iters, device, gen_items, on_step,
                    None, t_train0)
    # workers hide the GPUs, so their containment runs on the CPU
    contains_device = device if cfg.num_workers == 0 else torch.device("cpu")
    print("containment on:", contains_device,
          f"(num_workers={cfg.num_workers})")
    datasets = [TrainDataset(cfg, phase, yaw_list=yaw_list,
                             contains_device=contains_device)
                for phase in ("train", "test")]
    loader = DataLoader(datasets[0], batch_size=cfg.batch_size,
                        shuffle=not cfg.serial_batches,
                        num_threads=cfg.num_threads,
                        num_workers=cfg.num_workers, seed=cfg.seed)
    try:
        return _run(cfg, loader, max_iters, device, gen_items, on_step,
                    datasets, t_train0)
    finally:
        loader.close()          # the worker processes it started


def _run(cfg, loader, max_iters, device, gen_items, on_step, datasets,
         t_train0: float) -> Dict:
    """train()'s epochs on a resolved config and a built loader."""
    sec: Dict[str, float] = {}      # seconds of the loop's spans
    # float32 means float32: no TF32 in the f32 products and convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("train data size:", len(loader))

    model = surs_net_from_config(cfg, device)
    state = create_train_state(model, make_optimizer(cfg, model.parameters()))
    if fused_step_applies(cfg, device):
        from .fused_step import make_fused_train_step
        step_fn = make_fused_train_step(model, state.optimizer)
    else:
        step_fn = make_train_step(model, state.optimizer)

    ckpt = CheckpointManager(cfg.checkpoints_path, cfg.name)
    start_epoch = 0
    if cfg.load_netG_checkpoint_path:
        CheckpointManager(*os.path.split(os.path.abspath(
            cfg.load_netG_checkpoint_path))).restore(state, None)
    if cfg.continue_train == 0:  # reference quirk: 0 means resume
        epoch = None if cfg.resume_epoch < 0 else cfg.resume_epoch
        ckpt.restore(state, epoch)
        start_epoch = max(cfg.resume_epoch, 0)

    results = os.path.join(cfg.results_path, cfg.name)
    os.makedirs(results, exist_ok=True)
    # a torch.profiler trace of the epochs into cfg.profile_dir, started
    # and stopped where the JAX loop's is
    profiler = Profiler(cfg.profile_dir)
    profiler.start()

    def summary():
        return {"iters": iters_done, "wall_sec": time.time() - t_train0,
                "data_sec": sec.get("data_wait_s", 0.0),
                "enqueue_sec": sec.get("step_s", 0.0),
                "save_sec": sec.get("checkpoint_s", 0.0),
                "log_sec": sec.get("log_s", 0.0),
                "prep_sec": sec.get("h2d_s", 0.0),
                "ply_sec": sec.get("ply_s", 0.0)}

    lr = cfg.learning_rate
    iters_done = 0
    # Lagged loss logging: reading the current step's loss would wait for
    # the card to finish it; the previous log step's loss is long done.
    # The printed line is labelled with the step it belongs to.
    pending_log = None          # (epoch, idx, err tensor, data_t, net_t)
    for epoch in range(start_epoch, cfg.num_epoch):
        epoch_start = time.time()
        new_lr = lr_for_epoch(cfg.learning_rate, epoch, cfg.schedule,
                              cfg.gamma)
        if new_lr != lr:
            lr = new_lr
            set_learning_rate(state.optimizer, lr)
        batches = iter(loader)
        for idx in itertools.count():
            with annotate("surs.train.data_wait", sec) as waited:
                raw = next(batches, None)
            if raw is None:
                break
            with annotate("surs.train.h2d", sec) as prepared:
                host = batch_host_arrays(raw, quantize_images=True)
                batch = _to_device(host, device)
            with annotate("surs.train.step", sec) as stepped:
                state, metrics = step_fn(state, batch)
            if on_step is not None:
                on_step(state, metrics)
            if idx % cfg.freq_plot == 0:
                with annotate("surs.train.log", sec):
                    if pending_log is not None:
                        p_epoch, p_idx, err_d, d_t, n_t = pending_log
                        with host_wait():
                            err = float(err_d)
                        spent = time.time() - epoch_start
                        eta = spent / (idx + 1) * len(loader) - spent
                        print(f"Name: {cfg.name} | Epoch: {p_epoch} | "
                              f"{p_idx}/{len(loader)} | Err: {err:.06f} | "
                              f"LR: {lr:.06f} | Sigma: {cfg.sigma:.02f} | "
                              f"dataT: {d_t:.05f} | netT: {n_t:.05f} | "
                              f"ETA: {int(eta // 60):02d}:"
                              f"{int(eta % 60):02d}")
                    pending_log = (epoch, idx, metrics["total"],
                                   waited.seconds,
                                   prepared.seconds + stepped.seconds)
            if idx % cfg.freq_save == 0 and idx != 0:
                with annotate("surs.train.checkpoint", sec):
                    ckpt.save(state, epoch)
            if cfg.freq_save_ply > 0 and idx % cfg.freq_save_ply == 0:
                # reference quirk kept (apps/train_SuRS.py:166-184):
                # pred_hr, which the fine MLP evaluates at points_lr, is
                # plotted at the points_hr coordinates. Like the
                # reference, idx 0 of every epoch dumps; freq_save_ply
                # <= 0 turns the dumps off (the pred_hr read waits for
                # the card).
                with annotate("surs.train.ply", sec):
                    pts = host["points_hr"][0].T
                    save_samples_truncted_prob(
                        os.path.join(results, f"{epoch}pred.ply"), pts,
                        metrics["pred_hr"][0].float().cpu().numpy())
                    save_samples_truncted_prob(
                        os.path.join(results, f"{epoch}pred_gt.ply"), pts,
                        host["labels_hr"][0])
                    save_samples_truncted_prob(
                        os.path.join(results, f"{epoch}pred_lr.ply"),
                        host["points_lr"][0].T, host["labels_lr"][0])
            iters_done += 1
            if max_iters is not None and iters_done >= max_iters:
                with annotate("surs.train.checkpoint", sec):
                    ckpt.save(state, epoch)
                profiler.stop()
                return summary()
        with annotate("surs.train.checkpoint", sec):
            ckpt.save(state, epoch)
        if not cfg.no_gen_mesh:
            items = gen_items if gen_items is not None else \
                _dataset_gen_items(cfg, *datasets)
            _gen_meshes(cfg, state.model, device, items, epoch)
    profiler.stop()
    return summary()
