"""Training traffic: the fused training step (``train()`` with
``--fused_train``) fed by the port's ``DataLoader`` from seeded
in-memory items, until the harness's loader stops at the deadline.

Traffic parameters (``perfbench/traffic/<mix>.json``): ``batch``,
``points`` (a subject's samples, each of the HR and LR sets), ``items``
(distinct items, each batch holds ``batch`` of them in turn),
``warm_steps`` (set-up: the first steps, among them the ``checked_steps``
that the output check follows), ``config`` (training settings).

Each item is an image of uniform noise inside an ellipse silhouette (LR
at loadSize/2, HR its 2x repeat), the eval calibration, sample points
uniform in the +-0.5 box and the occupancy of an ellipsoid as labels
(the HR occupancy at the LR samples as the displacement labels, as the
dataset defines them); row i of ``items`` has its body's width scaled by
0.7 + 0.6 i / (items - 1), the same bodies for every seed. Images lie on the grid the loop ships them on
(k / 127 - 1), so the program and the reference see the same values.

The window runs from the end of the set-up's last step (synchronised)
to the end of the last step begun before ``--seconds`` passed, with one
synchronise at its end; ``step_s`` is its length over its steps. No
checkpoint is written inside it.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np

from .. import harness
from ..reference import train_check
from ..trace import Profiled


def make_items(traffic: Dict, load_size: int, seed: int) -> List[Dict]:
    rng = np.random.default_rng(int(seed))
    S, N = load_size // 2, int(traffic["points"])
    yy, xx = np.mgrid[:S, :S]

    def inside(p, axes):
        return (((p / axes[:, None]) ** 2).sum(0) < 1).astype(np.float32)

    n = int(traffic["items"])
    items = []
    for i in range(n):
        # each row its own body: silhouette and labels scaled 0.7-1.3
        s = 0.7 + 0.6 * i / max(n - 1, 1)
        axes = np.array([0.18 * s, 0.40, 0.15 * s])
        sil = ((((xx - S / 2) / (S * axes[0])) ** 2
                + ((yy - S / 2) / (S * axes[1])) ** 2) < 1)[..., None]
        k = rng.integers(0, 255, (S, S, 3))
        img_lr = (((k - 127) / 127.0) * sil).astype(np.float32)
        pts_hr = rng.uniform(-0.5, 0.5, (3, N)).astype(np.float32)
        pts_lr = rng.uniform(-0.5, 0.5, (3, N)).astype(np.float32)
        items.append({
            "name": f"item{i}", "img_LR": img_lr,
            "img_HR": np.repeat(np.repeat(img_lr, 2, 0), 2, 1),
            "mask_LR": sil.astype(np.float32),
            "calib": np.diag([2.0, -2.0, 2.0, 1.0]).astype(np.float32),
            "samples_HR": pts_hr, "samples_LR": pts_lr,
            "labels_HR": inside(pts_hr, axes)[None],
            "labels_disp": inside(pts_lr, axes)[None]})
    return items


class Items:
    """The items in turn, ``n`` of them."""

    def __init__(self, items, n: int):
        self.items, self.n = items, n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.items[i % len(self.items)]


class UntilStopped:
    """Batches of the port's loader until ``stop`` is set."""

    def __init__(self, loader):
        self.loader = loader
        self.stop = False

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for batch in self.loader:
            if self.stop:
                return
            yield batch


def write_start(tmp: str, params, cfg) -> str:
    """A train state in the loop's checkpoint format (step 0, the
    weights, an optimizer with no state yet); returns the path that
    ``load_netG_checkpoint_path`` takes."""
    import torch
    root = os.path.join(tmp, "start", "perfbench")
    os.makedirs(root)
    opt = {"state": {}, "param_groups": [{
        "lr": cfg.learning_rate, "momentum": cfg.momentum or 0.0,
        "betas": (cfg.beta1, cfg.beta2), "eps": cfg.epsilon,
        "weight_decay": cfg.weight_decay,
        "params": list(range(len(params)))}]}
    torch.save({"step": 0, "model": params, "optimizer": opt},
               os.path.join(root, "netG_latest"))
    return root


def model_config(run, tmp: str, start: str):
    from surs_tpu_torch.config import SuRSConfig
    t = {**run.traffic, **run.overrides.get("traffic", {})}
    kw = {**run.config["model"], **t.get("config", {}),
          **run.overrides.get("model", {})}
    kw.update(batch_size=int(t["batch"]), num_sample_inout=int(t["points"]),
              num_epoch=1, checkpoints_path=os.path.join(tmp, "out"),
              results_path=os.path.join(tmp, "out"), name="perfbench",
              load_netG_checkpoint_path=start)
    return SuRSConfig(**kw), t


def param_shapes(cfg):
    from ..reference import model as ref_model
    return ref_model.param_shapes(cfg.hg_dim, cfg.num_stack_lr,
                                  cfg.mlp_dim_lr, cfg.mlp_dim_hr)


def train_run(run, tmp: str, window: bool) -> Dict:
    """One ``train()`` call: the set-up steps (the first ``checked_steps``
    read for the check), then, with ``window``, the measured steps until
    the deadline. Returns the readings and, with ``window``, the
    window's measures."""
    import torch
    from surs_tpu_torch.data.loader import DataLoader
    from surs_tpu_torch.train.loop import train

    from ..reference import model as ref_model

    dev = torch.device(run.device)
    cfg0, t = model_config(run, tmp, "")
    params = ref_model.make_params(param_shapes(cfg0),
                                   run.config["weight_seed"], dev)
    start = write_start(tmp, params, cfg0)
    cfg = dataclasses.replace(cfg0, load_netG_checkpoint_path=start)
    items = make_items(t, cfg.loadSize, run.seed)
    warm = int(t["warm_steps"])
    checked = int(t["checked_steps"])
    loader = UntilStopped(DataLoader(
        Items(items, int(t["batch"]) * 100_000), batch_size=cfg.batch_size,
        shuffle=False))
    got: Dict = {"loss": []}
    w: Dict = {"steps": 0}
    prof = Profiled(run.trace and window)
    b1 = cfg.beta1

    def on_step(state, metrics):
        k = state.step
        if k <= checked:
            got["loss"].append(float(metrics["total"]))
            named = list(state.model.named_parameters())
            if k == 1:
                got["grad1"] = {
                    n: float((state.optimizer.state[p]["mu"] / (1 - b1))
                             .norm()) for n, p in named
                    if "mu" in state.optimizer.state.get(p, {})}
            if k == checked:
                got["change"] = {n: float((p.detach() - params[n]).norm())
                                 for n, p in named}
        if k == warm:
            run.sync()
            if not window:
                loader.stop = True
                return
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            w["setup_s"] = time.perf_counter() - run.t0
            w["built_at_setup"] = harness.build_log()
            prof.__enter__()
            w["t0"] = time.perf_counter()
        elif k > warm and window:
            w["steps"] += 1
            if time.perf_counter() >= w["t0"] + run.seconds:
                run.sync()
                w["window_s"] = time.perf_counter() - w["t0"]
                prof.__exit__(None, None, None)
                if dev.type == "cuda":
                    w["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
                loader.stop = True

    summary = train(cfg, loader, device=dev, on_step=on_step)
    return {"got": got, "window": w, "trace": prof.trace, "items": items,
            "params": params, "cfg": cfg, "summary": summary}


def run(run) -> Dict:
    import torch
    dev = torch.device(run.device)
    tmp = tempfile.mkdtemp(prefix="perfbench-train-")
    try:
        res = train_run(run, tmp, window=True)
        w = res["window"]
        out = {"setup_s": w["setup_s"], "window_s": w["window_s"],
               "steps": w["steps"], "step_s": w["window_s"] / w["steps"],
               "attempted": w["steps"], "failed": 0,
               "memory_peak_bytes": w.get("memory_peak_bytes", 0),
               "built_at_setup": w["built_at_setup"],
               "trace": res["trace"], "stats": {"steps": w["steps"]},
               "subjects": 0}
        cfg, items, params, got = (res["cfg"], res["items"], res["params"],
                                   res["got"])
        del res
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t_c = time.perf_counter()
        batch = train_check.batch_tensors(items[:cfg.batch_size], dev)
        want = train_check.reference_steps(
            params, batch, cfg, int(run.traffic["checked_steps"]))
        out["check"] = {"numbers": train_check.compare(got, want),
                        "info": {"loss": got["loss"],
                                 "ref_loss": want["loss"]}}
        out["check_s"] = time.perf_counter() - t_c
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
