"""Probe: can a hand-written kernel gather rows by index from a feature
map held on the card faster than PyTorch's gather from device memory?

The port's counterpart of ``benchmarks/vmem_gather_probe.py``, with its
constants and inputs: a [H * W, C] = [16384, 256] bf16 map and N = 49,152
int32 indices, both from ``np.random.default_rng(0)``. Variants:

  vec, loop      kernel K5 (``ops/row_gather.py``), the TPU probe's
                 variants A and B
  index_select   ``torch.index_select`` from device memory, the TPU
                 probe's variant C; the yardstick, used only here

One JSON line per variant: ``correct`` (bit-equal to the plain version
``row_gather_ref``), ``first_s`` (the first call, the nvcc build
included, host clock) and ``steady_ms`` (ms per iteration of a 20-deep
data-dependent chain, best of 3, CUDA events). Each iteration's sum
perturbs the next iteration's indices on the card, with no host sync
inside the chain; the card is held busy while the host enqueues the
chain, so the events time the card's work, as the TPU probe timed one
compiled chain. The map stays in L2 across the chain.

    python -m surs_tpu_torch.probes.vmem_gather_probe   # on the card
    main(device="cpu")      # the plain versions, for semantics; no times
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from ..config import resolve_device
from ..ops.row_gather import device_plan, row_gather, row_gather_ref

H = W = 128
C = 256
N = 49152          # 96 blocks of 512
BLOCK = 512        # the TPU probe's index block; K5 plans its own grid
DTYPE = torch.bfloat16
VARIANTS = ("vec", "loop", "index_select")
ITERS = 20
# clock cycles the card spins (torch.cuda._sleep) before a timed run, so
# that the host has enqueued the whole run when the card reaches it:
# about 10 ms at the H100's clock, against ~1 ms of enqueue
HOLD_CYCLES = 20_000_000


def probe_inputs(device):
    """feat [H * W, C] bf16 and idx [N] int32, as the TPU probe makes
    them."""
    rng = np.random.default_rng(0)
    feat = torch.from_numpy(rng.standard_normal((H * W, C))).to(DTYPE)
    idx = torch.from_numpy(rng.integers(0, H * W, N).astype(np.int32))
    return feat.to(device), idx.to(device)


def variant_fn(name: str):
    """fn(feat, idx) -> rows for one of ``VARIANTS``."""
    if name == "index_select":
        return lambda feat, idx: torch.index_select(feat, 0, idx)
    return lambda feat, idx: row_gather(feat, idx, name)


def chain(fn, feat, idx, iters: int = ITERS) -> torch.Tensor:
    """``iters`` gathers, each one's float32 sum moving the next one's
    indices; the sum of the sums, on the card."""
    rows = feat.shape[0]
    acc = torch.zeros((), dtype=torch.float32, device=feat.device)
    for _ in range(iters):
        s = fn(feat, idx).sum(dtype=torch.float32)
        idx = (idx + ((s.to(torch.int32) & 1) + 1)) % rows
        acc = acc + s
    return acc


def hold_card(cycles: int = HOLD_CYCLES) -> None:
    """Keep the current stream busy for about ``cycles`` clock cycles,
    touching no memory."""
    torch.cuda._sleep(cycles)


def chain_ms(fn, feat, idx, iters: int = ITERS, repeats: int = 3):
    """(best ms per iteration of :func:`chain`, its final sum)."""
    best, acc = float("inf"), None
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        hold_card()
        start.record()
        acc = chain(fn, feat, idx, iters)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best, float(acc)


def main(device=None):
    """Run every variant on ``device`` (CUDA unless named) and print one
    JSON line each; returns the records. On the CPU the variants take
    their plain versions and no times are taken."""
    dev = resolve_device(device)
    feat, idx = probe_inputs(dev)
    ref = row_gather_ref(feat, idx)
    on_card = dev.type == "cuda"
    name_of_device = torch.cuda.get_device_name(dev) if on_card else str(dev)
    records = []
    for name in VARIANTS:
        fn = variant_fn(name)
        t0 = time.perf_counter()
        out = fn(feat, idx)
        if on_card:
            torch.cuda.synchronize(dev)
        rec = {"probe": "vmem_gather", "variant": name,
               "device": name_of_device,
               "rows": H * W, "channels": C, "n": N, "dtype": "bfloat16",
               "correct": bool(torch.equal(out, ref))}
        if on_card:
            if name in ("vec", "loop"):
                rec["plan"] = vars(device_plan(feat, N, name))
            rec["first_s"] = time.perf_counter() - t0
            rec["steady_ms"], rec["chain_sum"] = chain_ms(fn, feat, idx)
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


if __name__ == "__main__":
    sys.exit(0 if all(r["correct"] for r in main()) else 1)
