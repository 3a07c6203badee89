"""Serving traffic: a backlog of subjects served back to back through
``SuRSService.reconstruct_many`` (a closed loop with one client, as the
serving CLI serves a watched folder), each subject an RGB image and its
silhouette, each answer an OBJ pair written into the harness's pipes.

Traffic parameters (``perfbench/traffic/<mix>.json``):

* ``pool``, ``image_size``: the subjects: an image of uniform noise from
  the seed and an ellipse silhouette; the ellipses are ``pool`` fixed
  shapes, ``ellipse_step`` from 0 to ``ellipse_steps`` (centre moved by
  (6, -4) pixels, x axis by 0.02 of the width a step, y axis 0.40), the
  same set for every seed, served in an order drawn from the seed;
* ``config``: settings of the served model's path (``use_octree``);
* ``check``: how many subjects, vertices, faces and columns the output
  check reads.

The service pipelines (subject i+1 begins before subject i's meshes are
extracted and written), so the window is taken in its steady state: it
runs from the completion of the first subject's OBJ pair to that of the
last subject begun before ``--seconds`` passed, and ``subject_s`` is its
length over the subjects completed inside it. One more subject is begun
after the deadline, as a backlog would have it, so the last counted
subject finishes beside the next one's evaluation as every other does.
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
from .. import sink as sink_mod
from ..reference import serve_check
from ..trace import Profiled, Spans


def make_pool(traffic: Dict, seed: int):
    """[(image uint8 [S, S, 3], mask uint8 [S, S])] and the serving
    order (a permutation of the pool), from the seed."""
    S = int(traffic["image_size"])
    n = int(traffic["pool"])
    steps = float(traffic.get("ellipse_steps", 2.0))
    rng = np.random.default_rng(int(seed))
    yy, xx = np.mgrid[:S, :S]
    pool = []
    for i in range(n):
        s = steps * i / max(n - 1, 1)
        img = (rng.random((S, S, 3)) * 255).astype(np.uint8)
        cx, cy = S / 2 + 6 * s, S / 2 - 4 * s
        ax, ay = S * (0.22 + 0.02 * s), S * 0.40
        mask = ((((xx - cx) / ax) ** 2 + ((yy - cy) / ay) ** 2) < 1
                ).astype(np.uint8) * 255
        pool.append((img, mask))
    return pool, rng.permutation(n)


def model_config(run):
    """The served SuRSConfig: the configuration's model, the mix's
    path settings and the test's overrides."""
    from surs_tpu_torch.config import SuRSConfig
    kw = {**run.config["model"], **run.traffic.get("config", {}),
          **run.overrides.get("model", {})}
    return SuRSConfig(**kw)


def annotate_service(service, spans: Spans):
    """Harness spans around the service's layers (encode, evaluate,
    extract, write); returns a function that takes them off."""
    from surs_tpu_torch.recon import pipeline
    rec = service.rec
    encode, evaluate, extract = rec.encode, rec.evaluate, rec.extract_pair
    write = pipeline.save_obj_mesh

    def wrap(name, fn):
        def call(*a, **kw):
            with spans(name):
                return fn(*a, **kw)
        return call

    def extract_pair(*a, **kw):
        gen = extract(*a, **kw)
        while True:
            with spans("extract"):
                item = next(gen, None)
            if item is None:
                return
            yield item

    rec.encode = wrap("encode", encode)
    rec.evaluate = wrap("evaluate", evaluate)
    rec.extract_pair = extract_pair
    pipeline.save_obj_mesh = wrap("write", write)

    def undo():
        del rec.encode, rec.evaluate, rec.extract_pair
        pipeline.save_obj_mesh = write
    return undo


def build(run, tmp: str):
    """(service, cfg, params): the served model, its weights made on the
    device from the configuration's seed and saved as a checkpoint in
    ``tmp`` that the service loads, as a user's would be."""
    import torch
    from surs_tpu_torch.serve import SuRSService

    from ..reference import model as ref_model

    dev = torch.device(run.device)
    cfg = model_config(run)
    shapes = ref_model.param_shapes(cfg.hg_dim, cfg.num_stack_lr,
                                    cfg.mlp_dim_lr, cfg.mlp_dim_hr)
    params = ref_model.make_params(shapes, run.config["weight_seed"], dev)
    ckpt = os.path.join(tmp, "netG_perfbench")
    torch.save({"step": 0, "model": params}, ckpt)
    cfg = dataclasses.replace(cfg, load_netG_checkpoint_path=ckpt)
    return SuRSService(cfg, device=dev), cfg, params


def run(run) -> Dict:
    import torch

    dev = torch.device(run.device)
    traffic = {**run.traffic, **run.overrides.get("traffic", {})}
    tmp = tempfile.mkdtemp(prefix="perfbench-serve-")
    out: Dict = {}
    sink = None
    try:
        service, cfg, params = build(run, tmp)
        pool, order = make_pool(traffic, run.seed)
        check = traffic["check"]
        sink = sink_mod.ObjSink(os.path.join(tmp, "obj"),
                                keep=int(check["subjects"]),
                                rng=np.random.default_rng(run.seed + 1))
        # set-up: one subject of the traffic through the timed path
        img, mask = pool[order[0]]
        sink.plan("warmup", sample=False)
        service.reconstruct_many([(img, mask, "warmup")], sink.dir,
                                 stats={})
        sink.wait()
        run.sync()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        out["setup_s"] = time.perf_counter() - run.t0
        out["built_at_setup"] = harness.build_log()

        spans = Spans()
        undo = annotate_service(service, spans) if run.trace else None
        served: List = []
        stats: Dict = {}
        with Profiled(run.trace, spans) as prof:
            t_w0 = time.perf_counter()
            deadline = t_w0 + run.seconds

            def items():
                i = 0
                while True:
                    due = time.perf_counter() < deadline
                    name = f"s{i:05d}" if due else "trailer"
                    k = int(order[i % len(order)])
                    sink.plan(name, sample=due)
                    served.append((name, k))
                    yield pool[k][0], pool[k][1], name
                    if not due:
                        return
                    i += 1

            pairs = service.reconstruct_many(items(), sink.dir, stats=stats)
            with spans("drain"):
                sink.wait()
            run.sync()
        if undo is not None:
            undo()
        counted = [name for name, _ in served[:-1]]
        done = [name for name in counted if name in sink.done_at]
        t_first = sink.done_at.get(counted[0], t_w0) if counted else t_w0
        t_last = sink.done_at.get(counted[-1], t_first) if counted else t_w0
        n_window = len(done) - 1 if len(done) > 1 else len(done)
        window_s = t_last - (t_first if len(done) > 1 else t_w0)
        out.update(attempted=len(served), failed=len(served) - len(pairs),
                   window_s=window_s, window_subjects=n_window,
                   stats=stats, trace=prof.trace, subjects=len(pairs))
        out["subject_s"] = window_s / max(n_window, 1)
        out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                    if dev.type == "cuda" else 0)
        out["obj_bytes"] = sink.bytes
        out["obj_crc32"] = sink.crc
        out["faces_per_subject"] = (float(np.sum(stats.get("faces", [])))
                                    / max(len(pairs), 1))
        for key in ("write_s", "extract_s"):
            out[key + "_per_subject"] = (stats.get(key, 0.0)
                                         / max(len(pairs), 1))
        kept = {name: sink.kept[name] for name, _ in served
                if name in sink.kept and len(sink.kept[name]) == 2}
        which = {name: k for name, k in served}
        sink.close()
        sink = None
        # the program's state goes before the reference runs
        del service
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t_c = time.perf_counter()
        subjects = [(pool[which[name]][0], pool[which[name]][1],
                     kept[name]) for name in sorted(kept)]
        out["check"] = serve_check.judge(
            run, cfg, params, subjects, check, expect=min(
                int(check["subjects"]), len(counted)))
        out["check_s"] = time.perf_counter() - t_c
        return out
    finally:
        if sink is not None:
            sink.close()
        shutil.rmtree(tmp, ignore_errors=True)
