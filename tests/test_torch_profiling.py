"""The port's profiling helpers (surs_tpu_torch/utils/profiling.py) and
train()'s ``profile_dir`` on the CPU, beside the JAX package's
surs_tpu/utils/profiling.py: the same names exported, ``timed`` with and
without a results dict, one Chrome trace a Profiler start / stop that
holds the annotated regions."""

import json
import os
import re

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
