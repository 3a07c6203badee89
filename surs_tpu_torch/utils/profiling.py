"""Profiling and timing utilities (counterpart of
``surs_tpu/utils/profiling.py``):

  * ``timed``: a block timer; CUDA tensors in ``sync`` are waited for
    before the clock is read;
  * ``Profiler``: ``torch.profiler`` trace collection into
    ``profile_dir`` (the ``--profile_dir`` knob), one Chrome trace a
    start / stop, with CUDA activity when a GPU is present;
  * ``annotate``: a named region, ``torch.profiler.record_function``
    and, where CUDA is available, an NVTX range.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


def _cuda_devices(sync) -> set:
    """The CUDA devices of the tensors in ``sync`` (a tensor or nested
    lists, tuples and dicts of them)."""
    found = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                found.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(sync)
    return found


@contextlib.contextmanager
def timed(label: str, results: Optional[dict] = None, sync=None):
    """Time the block; with ``results`` add the seconds to
    ``results[label]``, else print them. The devices of the CUDA tensors
    in ``sync`` are synchronised before the clock is read."""
    t0 = time.perf_counter()
    yield
    for dev in _cuda_devices(sync):
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    if results is not None:
        results[label] = results.get(label, 0.0) + dt
    else:
        print(f"[timing] {label}: {dt:.4f}s")


class Profiler:
    """``torch.profiler`` over start() .. stop(): CPU activity, and CUDA
    activity when a GPU is present. ``stop()`` writes one Chrome trace
    (``trace_<pid>_<n>.json``) into ``profile_dir``, made if missing, and
    keeps its path in ``last_trace``. Without a ``profile_dir`` both are
    no-ops."""

    def __init__(self, profile_dir: Optional[str] = None):
        self.dir = profile_dir
        self._prof = None
        self._count = 0
        self.last_trace: Optional[str] = None

    def start(self):
        if self.dir and self._prof is None:
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.__enter__()

    def stop(self):
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir,
                            f"trace_{os.getpid()}_{self._count}.json")
        self._count += 1
        prof.export_chrome_trace(path)
        self.last_trace = path

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()


@contextlib.contextmanager
def annotate(name: str):
    """A named trace region: ``record_function`` in the profiler's
    timeline and, where CUDA is available, an NVTX range."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
