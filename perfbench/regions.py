"""The program's own regions in a traced window: the ``surs.*`` spans
that ``surs_tpu_torch/utils/profiling.annotate`` records into the
profiler's trace while it runs, on the clock of the device's operations.
What the per-layer readers ask of them: the regions of one name, the
card-idle seconds inside them, a span's host milliseconds a step; and,
for the record in PERF.md, the window's idle seconds by the innermost
region the host was in.

A program without these spans (one older than them) has no such
regions: every read then returns nothing.

    python3 perfbench/regions.py --workload serve_mono-surs_bf16 \\
        --seed 7 --seconds 40 > regions.json

runs one traced cell (on the card) and prints, as one JSON line, the
window's idle seconds by region, the spans a subject or step, and the
host's waits: the program's ``stats["syncs"]`` beside the blocking CUDA
runtime calls of the trace, with the calls that no ``surs.sync`` region
holds named by the host operation and region around them; then the
run's result line. ``--span-cost``
prints the host microseconds of one span with no profiler recording and
with one.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from perfbench import yardstick  # noqa: E402

PREFIX = "surs."
# CUDA runtime calls that return only when the card has caught up
BLOCKING = ("cudaStreamSynchronize", "cudaEventSynchronize",
            "cudaDeviceSynchronize", "cudaMemcpy")

Interval = Tuple[float, float]


def outermost(trace, name: str) -> List[Interval]:
    """The host regions named ``name``, sorted, nested ones merged into
    the region that holds them."""
    out: List[Interval] = []
    for a, b in sorted((a, b) for n, a, b in trace.cpu_ops if n == name):
        if out and a < out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def overlap_s(xs: Sequence[Interval], ys: Sequence[Interval]) -> float:
    """Seconds covered by both of two sorted lists of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_inside(trace, name: str) -> Tuple[float, int]:
    """(seconds of the regions named ``name`` in which no device
    operation ran, the count of those regions)."""
    regs = outermost(trace, name)
    if not regs:
        return 0.0, 0
    idle = yardstick.gaps(((a, b) for _, _, a, b in trace.device_ops),
                          regs[0][0], regs[-1][1])
    return overlap_s(idle, regs), len(regs)


def ms_per_step(run, name: str):
    """Host milliseconds a step in the regions named ``name``, or None
    where the trace holds none."""
    tr = run.out.get("trace")
    steps = run.out.get("steps", 0)
    if tr is None or not steps:
        return None
    total = tr.cpu_op_s(name)
    return 1e3 * total / steps if total > 0 else None


def idle_by_region(trace, prefix: str = PREFIX) -> Dict[str, float]:
    """The window's idle seconds (no device operation running), each
    stretch given to the innermost program region that held the host
    then, or to ``outside``."""
    lo, hi = trace.window
    idle = yardstick.gaps(((a, b) for _, _, a, b in trace.device_ops),
                          lo, hi)
    regs = sorted(((a, b, n) for n, a, b in trace.cpu_ops
                   if n.startswith(prefix)), key=lambda r: (r[0], -r[1]))
    cuts = sorted({lo, hi, *(x for a, b, _ in regs for x in (a, b)),
                   *(x for g in idle for x in g)})
    by: Dict[str, float] = {}
    stack: List[Tuple[float, float, str]] = []
    r = g = 0
    for a, b in zip(cuts, cuts[1:]):
        if a < lo or b > hi:
            continue
        while r < len(regs) and regs[r][0] <= a:
            stack.append(regs[r])
            r += 1
        stack = [s for s in stack if s[1] > a]
        while g < len(idle) and idle[g][1] <= a:
            g += 1
        if g < len(idle) and idle[g][0] <= a:
            name = stack[-1][2] if stack else "outside"
            by[name] = by.get(name, 0.0) + (b - a)
    return dict(sorted(by.items(), key=lambda kv: -kv[1]))


def _blocking_calls(prof) -> List[Tuple[str, float, float]]:
    """(name, start_s, end_s) of the blocking CUDA runtime calls of a
    finished torch profiler, from its event list or else its Chrome
    trace."""
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name in BLOCKING:
            a = e.start_ns() * 1e-9
            out.append((name, a, a + e.duration_ns() * 1e-9))
    if out:
        return out
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    for e in events:
        if e.get("ph") == "X" and e.get("name") in BLOCKING:
            a = float(e["ts"]) * 1e-6
            out.append((e["name"], a, a + float(e.get("dur", 0)) * 1e-6))
    return out


class _Holders:
    """The innermost host operation around a time, among those that
    ``pred`` accepts (the nearest 4,096 starts before it are searched)."""

    def __init__(self, trace, pred):
        self.ops = sorted((a, b, n) for n, a, b in trace.cpu_ops if pred(n))
        self.starts = [a for a, _, _ in self.ops]

    def at(self, t: float) -> str:
        best, width = "none", float("inf")
        i = bisect.bisect_right(self.starts, t)
        for a, b, n in self.ops[max(0, i - 4096):i]:
            if b >= t and b - a < width:
                best, width = n, b - a
        return best


def audit(run, prof) -> Dict:
    """The record of one traced run: idle by region, spans a unit of
    work, the program's syncs against the trace's blocking calls."""
    tr = run.out["trace"]
    units = run.out.get("subjects") or run.out.get("steps") or 1
    st = run.out.get("stats") or {}
    counts: Dict[str, int] = {}
    for n, _, _ in tr.cpu_ops:
        if n.startswith(PREFIX):
            counts[n] = counts.get(n, 0) + 1
    calls = _blocking_calls(prof)
    syncs = outermost(tr, "surs.sync")
    sync_starts = [a for a, _ in syncs]
    ops = _Holders(tr, lambda n: not n.startswith(PREFIX)
                   and n not in BLOCKING)
    spans = _Holders(tr, lambda n: n.startswith(PREFIX))
    missed: Dict[str, int] = {}
    for name, a, b in calls:
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(sync_starts, mid)
        if i and syncs[i - 1][1] >= mid:
            continue
        op, region = ops.at(mid), spans.at(mid)
        key = f"{name} in {op} in {region}"
        missed[key] = missed.get(key, 0) + 1
    idle = idle_by_region(tr)
    total_idle = sum(idle.values())
    return {"workload": run.cell["name"], "seed": run.seed,
            "units": units, "window_s": tr.window_s,
            "idle_s": total_idle,
            "idle_in_regions_share": (1.0 - idle.get("outside", 0.0)
                                      / total_idle) if total_idle else None,
            "idle_by_region": idle,
            "spans_per_unit": sum(counts.values()) / units,
            "span_counts": counts,
            "syncs_per_unit": st.get("syncs", 0) / units,
            "sync_wait_s_per_unit": st.get("sync_wait_s", 0.0) / units,
            "blocking_calls_per_unit": len(calls) / units,
            "blocking_by_name": {n: sum(1 for c in calls if c[0] == n)
                                 for n in BLOCKING},
            "blocking_outside_sync_regions": dict(sorted(
                missed.items(), key=lambda kv: -kv[1]))}


def span_cost(n: int = 100_000) -> Dict[str, float]:
    """Host microseconds of one span (``annotate`` with a stats dict)
    over a loop of ``n``, with no profiler recording and with one."""
    import torch
    from surs_tpu_torch.utils.profiling import annotate
    from torch.profiler import ProfilerActivity, profile

    def loop():
        stats: Dict = {}
        t0 = time.perf_counter()
        for _ in range(n):
            with annotate("surs.cost", stats):
                pass
        return 1e6 * (time.perf_counter() - t0) / n

    def empty():
        t0 = time.perf_counter()
        for _ in range(n):
            pass
        return 1e6 * (time.perf_counter() - t0) / n

    out = {"n": n, "loop_us": empty(), "off_us": loop()}
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):
        out["on_us"] = loop()
    out["off_us_again"] = loop()
    return out


def traced(bench: Dict, workload: str, seed: int, seconds: float,
           device: str, overrides: Optional[Dict] = None):
    """One traced run of a cell: (the driven run, its finished torch
    profiler)."""
    from perfbench import harness
    from perfbench.drivers import serve, train
    from perfbench.trace import Profiled

    kept = []

    class Keep(Profiled):
        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            kept.append(self._prof)
            return out

    serve.Profiled = train.Profiled = Keep
    try:
        run = harness.prepare(bench, workload, seed, seconds, True,
                              time.perf_counter(), device, overrides)
        harness.drive(run)
    finally:
        serve.Profiled = train.Profiled = Profiled
    return run, kept[-1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--seconds", type=float, default=40.0)
    p.add_argument("--span-cost", action="store_true")
    args = p.parse_args(argv)
    if args.span_cost:
        print(json.dumps(span_cost()), flush=True)
        if not args.workload:
            return 0
    import torch
    if not torch.cuda.is_available():
        print("no card: a cell is traced on the card only", file=sys.stderr)
        return 3
    from perfbench import harness
    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    run, prof = traced(bench, args.workload, args.seed, args.seconds, "cuda")
    record = audit(run, prof)
    record["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(record, default=float), flush=True)
    # then the run's own result line, as run.py prints it
    return harness.print_result(harness.result(bench, run))


if __name__ == "__main__":
    sys.exit(main())
