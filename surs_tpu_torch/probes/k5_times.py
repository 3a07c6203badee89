"""Kernel K5's time per launch at the gather probe's shape (a [16384, 256]
bf16 map, 49,152 int32 indices from ``np.random.default_rng(0)``), its
variants beside ``torch.index_select`` and the plain version, read
three ways:

  cold_ms        a buffer larger than the L2 (256 MB) written before each
                 launch: the map is not in L2, but up to the L2's ~50 MB
                 of dirty lines are, and their write-back may fall inside
                 the timed launch;
  cold_clean_ms  the same, then a second such buffer read, so that L2
                 holds clean lines only, none of the map or the output;
  warm_ms        50 launches back to back: the map stays in L2.

A cold reading is the median of ``reps`` single launches, a warm one the
best of 3 runs; CUDA events, with the card held busy while the host
enqueues, so the events time the card's work.

    python surs_tpu_torch/probes/k5_times.py [--root DIR] [--sweep]

prints one JSON line (times, bit equality with the plain version, the
card's name and power limit). ``--root DIR`` times the K5 of another
checkout of this repository (its ``surs_tpu_torch.ops.row_gather``,
built from its own sources), so that two commits are compared on one
card in one call: run it as a file for that, not with ``-m``.
``--sweep`` also times this checkout's variants under other launch
plans than the default (vec's grid, loop's tile and ring depth).
chip_smoke.py's phase ``k5`` takes its timers from here.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROWS, C, N = 128 * 128, 256, 49152
FLUSH_BYTES = 256 << 20
# clock cycles the card spins before one cold launch (about 1 ms), and
# before a warm run (about 10 ms), so the host has enqueued the work
COLD_HOLD_CYCLES = 2_000_000
WARM_HOLD_CYCLES = 20_000_000


def time_cold(fn, reps: int, flush: torch.Tensor,
              clean: torch.Tensor = None) -> float:
    """Median milliseconds of one launch of ``fn`` after ``flush`` is
    written and, where given, ``clean`` is read (both larger than the
    L2); the events time the launch alone."""
    fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        if clean is not None:
            clean.sum()
        torch.cuda._sleep(COLD_HOLD_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def time_warm(fn, reps: int = 50, repeats: int = 3) -> float:
    """Milliseconds per launch of ``reps`` launches of ``fn`` back to
    back (L2 warm), best of ``repeats``."""
    fn()
    best = float("inf")
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(WARM_HOLD_CYCLES)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b) / reps)
    return best


def cold_buffers(device="cuda"):
    """(flush, clean): two buffers larger than the L2, for time_cold."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=device)
    clean = torch.zeros(FLUSH_BYTES // 4, dtype=torch.int32, device=device)
    return flush, clean


def measure(fns, reps: int = 20):
    """{"cold_ms", "cold_clean_ms", "warm_ms"}: {name: ms} for each of
    ``fns`` ({name: fn}), read in that order."""
    flush, clean = cold_buffers()
    out = {"cold_ms": {k: time_cold(f, reps, flush) for k, f in fns.items()},
           "cold_clean_ms": {k: time_cold(f, reps, flush, clean)
                             for k, f in fns.items()},
           "warm_ms": {k: time_warm(f) for k, f in fns.items()}}
    del flush, clean
    torch.cuda.empty_cache()
    return out


def probe_inputs(device="cuda"):
    rng = np.random.default_rng(0)
    feat = torch.from_numpy(rng.standard_normal((ROWS, C))).to(torch.bfloat16)
    idx = torch.from_numpy(rng.integers(0, ROWS, N).astype(np.int32))
    return feat.to(device), idx.to(device)


def sweep(rg, feat, idx):
    """Cold-clean and warm ms of vec and loop under other plans than the
    default, one record each."""
    dev = feat.device
    row_bytes = feat.shape[1] * feat.element_size()
    flush, clean = cold_buffers()
    plans = []
    base = rg.device_plan(feat, N, "vec")
    for grid in sorted({max(1, base.grid // 2), base.grid, 2 * base.grid,
                        4 * base.grid}):
        plans.append(rg.GatherPlan("vec", grid, rg.VEC_THREADS))
    sms = rg._sms(dev)
    for stage_bytes in (8192, 16384, 32768):
        tile = stage_bytes // row_bytes
        for stages in (3, 4, 6):
            smem = rg.LOOP_BARRIER_BYTES + stages * stage_bytes
            occ = rg._occupancy(dev, "loop", "bf16", smem)
            grid = min(sms * occ, -(-N // tile))
            plans.append(rg.GatherPlan("loop", grid, rg.LOOP_THREADS, tile,
                                       stages, stage_bytes, smem))
    want = rg.row_gather_ref(feat, idx)
    recs = []
    for plan in plans:
        fn = (lambda p: lambda: rg.row_gather(feat, idx, p.variant, p))(plan)
        rec = {"probe": "k5_sweep", **vars(plan),
               "equal": bool(torch.equal(fn(), want)),
               "cold_clean_ms": time_cold(fn, 20, flush, clean),
               "warm_ms": time_warm(fn)}
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    return recs


def power_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)),
                    help="checkout whose K5 is timed (default: this one)")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: K5's times are taken on the card",
              file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from surs_tpu_torch import roofline
    from surs_tpu_torch.ops import row_gather as rg
    if not os.path.abspath(rg.__file__).startswith(root + os.sep):
        raise RuntimeError(f"row_gather came from {rg.__file__}, not "
                           f"{root}: run this file as a script")
    with open(os.path.join(root, "surs_tpu_torch", "csrc",
                           "row_gather.cu"), "rb") as f:
        source = hashlib.sha256(f.read()).hexdigest()[:16]
    feat, idx = probe_inputs()
    want = rg.row_gather_ref(feat, idx)
    fns = {v: (lambda v: lambda: rg.row_gather(feat, idx, v))(v)
           for v in rg.VARIANTS}
    equal = {v: bool(torch.equal(f(), want)) for v, f in fns.items()}
    fns.update(index_select=lambda: torch.index_select(feat, 0, idx),
               plain=lambda: rg.row_gather_ref(feat, idx))
    flops, nbytes = roofline.k5_work(ROWS, N, C)
    bound_ms, bound_by = roofline.bound(flops, nbytes, "bfloat16")
    rec = {"probe": "k5_times", "root": root, "row_gather_cu": source,
           "card": power_limit(), "rows": ROWS, "channels": C, "n": N,
           "dtype": "bfloat16", "equal": equal, **measure(fns),
           "bound_ms": bound_ms, "bound_by": bound_by, "mbytes": nbytes / 1e6}
    print(json.dumps(rec), flush=True)
    if args.sweep:
        sweep(rg, feat, idx)
    return 0 if all(equal.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
