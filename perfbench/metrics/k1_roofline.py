"""The bf16 K1's share of its roofline: the least time of the window's
point queries (each call's points read once, its bf16 weights once) at
the bf16 peak, over the trace's time in ``fused_dual_mlp_wgmma_kernel``."""

from perfbench import work, yardstick

KEYS = ("fused_dual_mlp_wgmma_kernel",)


def read(run):
    st = run.out.get("stats") or {}
    if st.get("mode") != "octree-mono" \
            or run.config["model"]["feature_dtype"] != "bfloat16":
        return None

    def cost(calls):
        flops, nbytes = yardstick.k1_work(st["queries"], "bfloat16")
        w = yardstick.dual_mlp_macs() * 2
        return flops, nbytes + (calls - 1) * w, "bfloat16"
    return work.kernel_share(run, KEYS, cost)
