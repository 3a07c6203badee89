"""Profiling and timing utilities (counterpart of
``surs_tpu/utils/profiling.py``):

  * ``timed``: a block timer; CUDA tensors in ``sync`` are waited for
    before the clock is read;
  * ``Profiler``: ``torch.profiler`` trace collection into
    ``profile_dir`` (the ``--profile_dir`` knob), one Chrome trace a
    start / stop, with CUDA activity when a GPU is present;
  * ``annotate``: the port's span, a named region of the program timed
    into a ``stats`` dict and, while a profiler records, a
    ``record_function`` region in its trace and (where CUDA is
    available) an NVTX range; ``host_wait`` is the span of a place where
    the host waits on the card (``surs.sync``), counted.

Spans cost one ``perf_counter`` pair and a check of whether a profiler
records: ``record_function`` alone costs microseconds even with no
profiler, so it is entered only while one records (``--profile_dir``, or
any ``torch.profiler.profile`` around the call). A span carries no
arguments into the trace; on one thread the order of the spans says
which subject or step each belongs to.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch
from torch.autograd.profiler import record_function

_recording = torch.autograd._profiler_enabled
_clock = time.perf_counter
# a span name's stats key, "surs.write" -> "write_s", by name
_KEYS: dict = {}


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


class annotate:
    """``with annotate(name, stats):`` a span: the block's seconds are
    added to ``stats[key]`` (default: the name's last dotted part +
    ``_s``, so ``surs.write`` -> ``write_s``) and, with ``count``, one to
    the integer ``stats[count]``; ``seconds`` holds the block's seconds
    after it. Only while a torch profiler records (checked once, at
    entry) is the block also a ``record_function(name)`` region and,
    where CUDA is available, an NVTX range; otherwise neither is
    called. The updates take no lock: a stats dict is written by one
    thread at a time."""

    __slots__ = ("name", "stats", "key", "count", "seconds", "_t0", "_rf",
                 "_nvtx")

    def __init__(self, name: str, stats: Optional[dict] = None,
                 key: Optional[str] = None, count: Optional[str] = None):
        self.name = name
        self.stats = stats
        self.key = key
        self.count = count

    def __enter__(self):
        if _recording():
            self._nvtx = torch.cuda.is_available()
            if self._nvtx:
                torch.cuda.nvtx.range_push(self.name)
            self._rf = record_function(self.name)
            self._rf.__enter__()
        else:
            self._rf = None
        self._t0 = _clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = self.seconds = _clock() - self._t0
        if self._rf is not None:
            self._rf.__exit__(exc_type, exc, tb)
            if self._nvtx:
                torch.cuda.nvtx.range_pop()
        st = self.stats
        if st is not None:
            key = self.key
            if key is None:
                key = _KEYS.get(self.name)
                if key is None:
                    key = _KEYS[self.name] = \
                        self.name.rsplit(".", 1)[-1] + "_s"
            st[key] = st.get(key, 0.0) + dt
            if self.count is not None:
                st[self.count] = st.get(self.count, 0) + 1
        return False


def host_wait(stats: Optional[dict] = None) -> annotate:
    """The span of a place where the host waits for the card (a result
    read back, an event waited for, a copy from pageable memory, which
    waits for the stream): ``surs.sync``, counted in ``stats["syncs"]``,
    its seconds in ``stats["sync_wait_s"]``."""
    return annotate("surs.sync", stats, "sync_wait_s", "syncs")
