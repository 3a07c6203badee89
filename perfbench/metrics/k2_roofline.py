"""K2's share of its roofline: the window's forward calls (one a stack a
step, each on batch x points rows) as 3xTF32 at the TF32 peak, over the
trace's time in the kernels named ``fused_dual_mlp_train`` (its pack,
split, GEMM and head kernels)."""

from perfbench import work, yardstick

KEYS = ("fused_dual_mlp_train",)


def read(run):
    steps = run.out.get("steps", 0)
    if not steps:
        return None
    t = {**run.traffic, **run.overrides.get("traffic", {})}
    rows = int(t["batch"]) * int(t["points"])
    calls = steps * int(run.config["model"]["num_stack_lr"])

    def cost(_):
        flops, nbytes = yardstick.k2_tf32x3_work(rows)
        return calls * flops, calls * nbytes, "tf32"
    return work.kernel_share(run, KEYS, cost)
