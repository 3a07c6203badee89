"""The float32 K3's share of its roofline: each served subject's whole
R^3 grid by columns (feature products once a column, the hidden chain
at every depth) as 3xTF32 at the TF32 peak, over the trace's time in
``cols_terms_tf32x3_kernel`` and ``fused_dual_mlp_cols_tf32x3_kernel``."""

from perfbench import work, yardstick

KEYS = ("cols_terms_tf32x3_kernel", "fused_dual_mlp_cols_tf32x3_kernel")


def read(run):
    st = run.out.get("stats") or {}
    n = run.out.get("subjects", 0)
    if st.get("mode") != "dense-cols" or not n \
            or run.config["model"]["feature_dtype"] != "float32":
        return None
    R = run.config["model"]["resolution"]

    def cost(calls):
        flops, nbytes = yardstick.k3_tf32x3_work(R * R, R)
        return n * flops, n * nbytes, "tf32"
    return work.kernel_share(run, KEYS, cost)
