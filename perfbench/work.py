"""Model work of a window, for the per-layer readers: the trunk's
operations counted once by ``FlopCounterMode`` over the plain model at
the cell's shapes (on the meta device, so nothing runs), the point MLPs'
from the yardstick for the points and columns actually run, each part
at the peak of the arithmetic its configuration states."""

from __future__ import annotations

import functools
from typing import Optional

from . import yardstick

@functools.lru_cache(maxsize=None)
def trunk_flops(load_size: int, hg_dim: int, num_stack: int,
                backward: bool = False) -> float:
    """Operations of one image through the SR net and both hourglass
    filters (forward, or forward and backward)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from .reference import model as ref
    S = load_size // 2
    shapes = ref.param_shapes(hg_dim, num_stack)
    with torch.device("meta"):
        params = {n: torch.empty(s, requires_grad=backward)
                  for n, s in shapes.items()}
        x = torch.empty(1, S, S, 3)
    with FlopCounterMode(display=False) as fc:
        img_sr, feats, feat_hr = ref.encode(x, params, num_stack)
        if backward:
            loss = img_sr.sum() + feat_hr.sum() + sum(f.sum() for f in feats)
            loss.backward()
    return float(fc.get_total_flops())


def serve_least_s(run) -> Optional[float]:
    """Least seconds the card could take for the window's subjects (the
    program's counts are over every subject served, so a subject's
    average stands for each of the window's)."""
    st = run.out.get("stats") or {}
    n = run.out.get("subjects", 0)
    if not n or "mode" not in st:
        return None
    scale = run.out.get("window_subjects", n) / n
    m = run.config["model"]
    trunk_peak = "bfloat16" if m["dtype"] == "bfloat16" else "float32"
    t = n * trunk_flops(m["loadSize"], m["hg_dim"], m["num_stack_lr"]) \
        / yardstick.PEAK_FLOPS[trunk_peak]
    R = m["resolution"]
    f32 = m["feature_dtype"] == "float32"
    if st["mode"] == "dense-cols":
        flops = n * (yardstick.k3_tf32x3_work(R * R, R)[0] if f32
                     else yardstick.k3_work(R * R, R, "bfloat16")[0])
    elif st["mode"] == "octree-mono":
        q = st["queries"]
        flops = (yardstick.k1_tf32x3_work(q)[0] if f32
                 else yardstick.k1_work(q, "bfloat16")[0])
    else:
        return None
    return scale * (t + flops / yardstick.PEAK_FLOPS["tf32" if f32
                                                    else "bfloat16"])


def kernel_share(run, keys, work) -> Optional[float]:
    """A kernel's roofline share in % over the traced window: the least
    time of ``work(calls)`` -> (flops, bytes, peak) over the summed time
    of the kernels whose names hold ``keys``."""
    tr = run.out.get("trace")
    if tr is None:
        return None
    took = tr.kernel_s(keys)
    calls = tr.kernel_count(keys[-1:])
    if took <= 0.0 or calls == 0:
        return None
    flops, nbytes, peak = work(calls)
    return yardstick.share_pct(yardstick.bound_s(flops, nbytes, peak), took)
