"""The device trace of a measured window, from ``torch.profiler``: the
device's operations (kernels, copies, sets) with their names and times,
the harness's own spans (``span``), and what the per-layer readers ask
of them: the time of the kernels whose names hold a key, the device's
busy seconds (the union of its operations' intervals), and the idle
stretches named by the harness span the host was in.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

from . import yardstick

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Host spans of the harness, (name, start_ns, end_ns) on the wall
    clock that the profiler's events use."""

    def __init__(self):
        self.items: List[Tuple[str, int, int]] = []
        self.on = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.items.append((name, t0, time.time_ns()))


class Trace:
    """Device operations [(name, kind, start_s, end_s)] and the host's
    CPU operations [(name, start_s, end_s)] of one traced window, with
    the window's (start_s, end_s)."""

    def __init__(self, device_ops, cpu_ops, window: Tuple[float, float],
                 spans: Sequence[Tuple[str, float, float]] = ()):
        self.device_ops = device_ops
        self.cpu_ops = cpu_ops
        self.window = window
        self.spans = list(spans)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def kernel_s(self, keys: Sequence[str]) -> float:
        """Summed seconds of the kernels whose names hold any key."""
        return sum(b - a for n, kind, a, b in self.device_ops
                   if kind == "kernel" and any(k in n for k in keys))

    def kernel_count(self, keys: Sequence[str]) -> int:
        return sum(1 for n, kind, _, _ in self.device_ops
                   if kind == "kernel" and any(k in n for k in keys))

    def busy_s(self) -> float:
        lo, hi = self.window
        return yardstick.union_s((max(a, lo), min(b, hi))
                                 for _, _, a, b in self.device_ops
                                 if b > lo and a < hi)

    def cpu_op_s(self, name: str) -> float:
        """Seconds of the host operations named ``name`` (the outermost
        of nested ones)."""
        hits = sorted((a, b) for n, a, b in self.cpu_ops if n == name)
        total, end = 0.0, float("-inf")
        for a, b in hits:
            if a >= end:
                total += b - a
                end = b
        return total

    def device_top(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for name, _, a, b in self.device_ops:
            by[name] = by.get(name, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_top(self, n: int = 10) -> List[List]:
        """Idle seconds of the window, summed by the innermost harness
        span that held the host at each idle stretch's middle."""
        lo, hi = self.window
        idle = yardstick.gaps(((a, b) for _, _, a, b in self.device_ops),
                              lo, hi)
        spans = sorted(self.spans, key=lambda s: s[1])
        by: Dict[str, float] = {}
        for a, b in idle:
            mid = 0.5 * (a + b)
            name, width = "outside spans", float("inf")
            for sname, s0, s1 in spans:
                if s0 <= mid <= s1 and s1 - s0 < width:
                    name, width = sname, s1 - s0
            by[name] = by.get(name, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:n]]


def _kind(e) -> str:
    """The activity of a profiler event, where this PyTorch has no
    ``activity_type``: device events by name, host events by whether
    they are user annotations."""
    try:
        return e.activity_type()
    except AttributeError:
        pass
    annotation = getattr(e, "is_user_annotation", None)
    if "CUDA" in str(e.device_type()):
        name = e.name()
        if annotation and annotation():
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    return "user_annotation" if annotation and annotation() else "cpu_op"


def _kineto_events(prof):
    """(device ops, cpu ops) from the profiler's own event list, or None
    where this PyTorch does not expose it."""
    try:
        events = prof.profiler.kineto_results.events()
    except AttributeError:
        return None
    dev, cpu = [], []
    for e in events:
        kind = _kind(e)
        a = e.start_ns() * 1e-9
        b = a + e.duration_ns() * 1e-9
        if kind in DEVICE_KINDS:
            dev.append((e.name(), kind, a, b))
        elif kind in ("cpu_op", "user_annotation"):
            cpu.append((e.name(), a, b))
    # a host annotation's mirror on the device's timeline (such as the
    # optimizer's ``Optimizer.step#...``) is no device operation
    host_names = {n for n, _, _ in cpu}
    return [d for d in dev if d[0] not in host_names], cpu


def _chrome_events(prof):
    """The same read from an exported Chrome trace (microseconds)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    dev, cpu = [], []
    for e in events:
        if e.get("ph") != "X" or "ts" not in e:
            continue
        a = float(e["ts"]) * 1e-6
        b = a + float(e.get("dur", 0)) * 1e-6
        kind = e.get("cat")
        if kind in DEVICE_KINDS:
            dev.append((e.get("name", ""), kind, a, b))
        elif kind in ("cpu_op", "user_annotation"):
            cpu.append((e.get("name", ""), a, b))
    return dev, cpu


class Profiled:
    """``with Profiled(on) as p:`` traces the block when ``on`` (CPU and
    CUDA activity); ``p.trace`` then holds its :class:`Trace`, with the
    block's wall-clock bounds as the window."""

    def __init__(self, on: bool, spans: Optional[Spans] = None):
        self.on = on
        self.spans = spans
        self.trace: Optional[Trace] = None
        self._prof = None

    def __enter__(self):
        if self.on:
            import torch
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            if self.spans is not None:
                self.spans.on = True
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        if self._prof is None:
            return False
        self._prof.__exit__(*exc)
        if self.spans is not None:
            self.spans.on = False
        if exc[0] is None:
            try:
                got = _kineto_events(self._prof)
            except (AttributeError, TypeError):
                got = None
            if got is None or (not got[0] and not got[1]):
                got = _chrome_events(self._prof)
            spans = [(n, a * 1e-9, b * 1e-9) for n, a, b in
                     (self.spans.items if self.spans is not None else [])]
            window = (self._t0 * 1e-9, t1 * 1e-9)
            inside = sum(1 for _, _, a, _ in got[0]
                         if window[0] <= a <= window[1])
            if got[0] and got[1] and inside < 0.5 * len(got[0]):
                # the profiler keeps another clock: the window is then
                # the span of its own host events, and the harness spans
                # are moved by the difference of the two starts
                lo = min(a for _, a, _ in got[1])
                hi = max(b for _, _, b in got[1])
                shift = lo - window[0]
                window = (lo, hi)
                spans = [(n, a + shift, b + shift) for n, a, b in spans]
            self.trace = Trace(got[0], got[1], window, spans)
        return False
