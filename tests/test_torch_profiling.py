"""The port's profiling helpers (surs_tpu_torch/utils/profiling.py) and
train()'s ``profile_dir`` on the CPU, beside the JAX package's
surs_tpu/utils/profiling.py: the same names exported, ``timed`` with and
without a results dict, one Chrome trace a Profiler start / stop that
holds the annotated regions; the spans of the serving and training paths
with and without a profiler recording."""

import json
import os
import re

import numpy as np
import pytest
import torch

import surs_tpu.utils as jax_utils
import surs_tpu_torch.utils as utils
from surs_tpu_torch.data.loader import DataLoader
from surs_tpu_torch.train.loop import train
from surs_tpu_torch.utils.profiling import Profiler, annotate, timed
from tests.test_torch_train import tiny_cfg, train_items

torch.set_num_threads(1)


def trace_events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_exports_match_jax():
    assert sorted(utils.__all__) == sorted(jax_utils.__all__)
    for name in utils.__all__:
        assert callable(getattr(utils, name))


def test_timed_accumulates_and_prints(capsys):
    results = {}
    for _ in range(2):
        with timed("block", results, sync=[torch.ones(2)]):
            torch.ones(100).sum()
    assert list(results) == ["block"] and results["block"] > 0
    with timed("printed"):
        pass
    assert re.fullmatch(r"\[timing\] printed: \d+\.\d{4}s\n",
                        capsys.readouterr().out)


def test_profiler_writes_one_trace_with_its_regions(tmp_path):
    d = tmp_path / "prof"
    with Profiler(str(d)) as prof:
        with annotate("outer_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.listdir(d) == [os.path.basename(prof.last_trace)]
    names = {e.get("name") for e in trace_events(prof.last_trace)}
    assert "outer_region" in names
    assert any("mm" in str(n) for n in names)
    # no profile_dir: start / stop do nothing
    idle = Profiler(None)
    idle.start()
    idle.stop()
    assert idle.last_trace is None


def test_annotate_leaves_cuda_alone_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def refuse(*_):
        raise AssertionError("nvtx called on a CPU-only build")
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", refuse)
    with annotate("cpu_region"):
        pass


@pytest.mark.parametrize("max_iters", [1, None])
def test_train_with_profile_dir_writes_a_trace(tmp_path, max_iters):
    """train() traces its steps into profile_dir instead of raising:
    stopped at max_iters' return and at the end of the epochs."""
    cfg = tiny_cfg(tmp_path, profile_dir=str(tmp_path / "prof"))
    loader = DataLoader(train_items(2), batch_size=2, shuffle=False)
    out = train(cfg, loader, max_iters=max_iters, device="cpu")
    assert out["iters"] == 1
    traces = os.listdir(tmp_path / "prof")
    assert len(traces) == 1 and traces[0].endswith(".json")
    names = {e.get("name") for e in trace_events(
        str(tmp_path / "prof" / traces[0]))}
    assert any("Optimizer.step" in str(n) for n in names)


# ------------------------------------------------------------- the spans ---
SERVE = dict(loadSize=32, num_stack_lr=1, resolution=32,
             octree_init_resolution=8, num_samples=4096,
             b_min=[-0.5, -0.5, -0.5], b_max=[0.5, 0.5, 0.5],
             mask_prune=True, dtype="float32", feature_dtype="float32",
             mc_backend="device", mc_algorithm="cubes", seed=2)
LEVELS = 3          # strides 4, 2, 1 of the 32^3 grid from 8^3
SERVE_SECONDS = ("encode_s", "evaluate_s", "extract_s", "write_s",
                 "sync_wait_s")
TRAIN_PHASES = ("data_wait", "h2d", "step", "forward", "backward",
                "optimizer", "log", "ply")


def subject(S=16):
    rng = np.random.default_rng(0)
    img = (rng.random((S, S, 3)) * 255).astype(np.uint8)
    yy, xx = np.mgrid[:S, :S]
    mask = (((xx - S / 2) / (S * 0.3)) ** 2
            + ((yy - S / 2) / (S * 0.42)) ** 2 < 1).astype(np.uint8) * 255
    return img, mask


def serve_one(tmp_path, n=1, writer_thread=False):
    """``n`` subjects through reconstruct_many's pipelined path on the
    CPU; returns their stats."""
    from surs_tpu_torch.config import SuRSConfig
    from surs_tpu_torch.serve import SuRSService
    svc = SuRSService(SuRSConfig(**SERVE), device="cpu")
    stats = {}
    pairs = svc.reconstruct_many([(*subject(), f"s{i}") for i in range(n)],
                                 str(tmp_path / "out"), pipeline=True,
                                 stats=stats, writer_thread=writer_thread)
    assert len(pairs) == n
    return stats


def train_two(tmp_path, **kw):
    """Two steps of train() on the CPU, a log line and PLYs each."""
    cfg = tiny_cfg(tmp_path, freq_plot=1, freq_save_ply=1, **kw)
    loader = DataLoader(train_items(4), batch_size=2, shuffle=False)
    return train(cfg, loader, max_iters=2, device="cpu")


def spans(path, prefix="surs."):
    """{name: [(start_us, end_us)]} of the trace's regions."""
    out = {}
    for e in trace_events(path):
        if e.get("ph") == "X" and str(e.get("name", "")).startswith(prefix) \
                and e.get("cat") == "user_annotation":
            out.setdefault(e["name"], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    return out


def test_a_span_adds_its_seconds_and_counts():
    from surs_tpu_torch.utils.profiling import host_wait
    stats = {}
    for _ in range(3):
        with annotate("surs.some.block", stats) as span:
            pass
        with host_wait(stats):
            pass
    assert set(stats) == {"block_s", "sync_wait_s", "syncs"}
    assert stats["syncs"] == 3 and span.seconds > 0
    assert stats["block_s"] >= span.seconds
    with annotate("surs.named", stats, key="own_s", count="calls"):
        pass
    assert stats["calls"] == 1 and stats["own_s"] > 0


@pytest.mark.parametrize("path", ["serve", "train"])
def test_no_profiler_no_trace_calls(tmp_path, monkeypatch, path):
    """With no profiler recording, the serving and training paths call
    neither record_function nor NVTX, and still fill their stats and
    summary."""
    from surs_tpu_torch.utils import profiling

    def refuse(*_a, **_k):
        raise AssertionError("a trace call with no profiler recording")
    monkeypatch.setattr(profiling, "record_function", refuse)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", refuse)
    if path == "serve":
        stats = serve_one(tmp_path)
        for key in SERVE_SECONDS:
            assert stats[key] > 0, key
        assert stats["levels"] == LEVELS and stats["syncs"] > 0
        assert stats["queries"] > 0 and len(stats["faces"]) == 2
    else:
        out = train_two(tmp_path)
        assert out["iters"] == 2
        for key in ("data_sec", "prep_sec", "enqueue_sec", "log_sec",
                    "save_sec", "ply_sec"):
            assert out[key] > 0, key


def test_the_writer_thread_counts_as_one_thread(tmp_path):
    """With the finish stage on a worker thread, each subject keeps its
    own stats, added up after: the same counts as on one thread."""
    one = serve_one(tmp_path / "one", n=3)
    two = serve_one(tmp_path / "two", n=3, writer_thread=True)
    for key in ("syncs", "levels", "queries", "faces", "mode", "mc"):
        assert two[key] == one[key], key
    assert set(two) == set(one)


def test_a_traced_subject_holds_its_spans(tmp_path):
    with Profiler(str(tmp_path / "prof")) as prof:
        stats = serve_one(tmp_path)
    got = spans(prof.last_trace)
    assert {k: len(v) for k, v in got.items()
            if k != "surs.sync"} == {
        "surs.encode": 1, "surs.evaluate": 1,
        "surs.evaluate.level": LEVELS, "surs.extract": 2, "surs.write": 2}
    (e0, e1), = got["surs.evaluate"]
    assert all(e0 <= a and b <= e1 for a, b in got["surs.evaluate.level"])
    assert len(got["surs.sync"]) == stats["syncs"] > 0
    assert stats["levels"] == LEVELS
    for key in SERVE_SECONDS:
        assert stats[key] > 0, key


def test_a_traced_step_holds_each_phase_once(tmp_path):
    out = train_two(tmp_path, profile_dir=str(tmp_path / "prof"))
    path, = [os.path.join(tmp_path / "prof", p)
             for p in os.listdir(tmp_path / "prof")]
    got = spans(path)
    for phase in TRAIN_PHASES:
        assert len(got["surs.train." + phase]) == 2, phase
    assert len(got["surs.train.checkpoint"]) == 1
    assert len(got["surs.sync"]) == 1           # the lagged loss read
    for key, phase in (("data_sec", "data_wait"), ("enqueue_sec", "step"),
                       ("prep_sec", "h2d")):
        traced = 1e-6 * sum(b - a for a, b in got["surs.train." + phase])
        assert out[key] == pytest.approx(traced, rel=0.05, abs=1e-3), key
