"""The training window's share of the card's peak: the least time of its
steps' model work over the window's wall time, in %. Per step: the trunk
forward and backward (FlopCounterMode over the plain model) at the
trunk's stated peak for each image; the point MLPs' forward (K2, 3xTF32:
three TF32 products at the TF32 peak) and their backward, a recompute
and two products in float32 with TF32 off, at the float32 peak."""

from perfbench import work, yardstick


def read(run):
    steps = run.out.get("steps", 0)
    if not steps:
        return None
    m = run.config["model"]
    t = {**run.traffic, **run.overrides.get("traffic", {})}
    B, N = int(t["batch"]), int(t["points"])
    trunk_peak = "bfloat16" if m["dtype"] == "bfloat16" else "float32"
    trunk = B * work.trunk_flops(m["loadSize"], m["hg_dim"],
                                 m["num_stack_lr"], backward=True)
    fwd = m["num_stack_lr"] * 2.0 * yardstick.dual_mlp_macs() * B * N
    least = (trunk / yardstick.PEAK_FLOPS[trunk_peak]
             + 3 * fwd / yardstick.PEAK_FLOPS["tf32"]
             + 3 * fwd / yardstick.PEAK_FLOPS["float32"])
    return yardstick.share_pct(steps * least, run.out["window_s"])
