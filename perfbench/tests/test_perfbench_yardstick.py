"""The frozen yardstick: work from shapes, shares never above 100 % on
synthetic traces, float32 counted as three TF32 products at 495 TFLOP/s."""

import pytest

from perfbench import work, yardstick
from perfbench.trace import Trace


def test_float32_counts_three_tf32_products_at_495():
    f1, b1 = yardstick.k1_work(50_000, "float32")
    f3, b3 = yardstick.k1_tf32x3_work(50_000)
    assert f3 == 3 * f1 and b3 == b1
    assert yardstick.PEAK_FLOPS["tf32"] == 495e12
    # the float32 K3 grid: 3 x its operations at the TF32 peak, never at
    # the 67 TFLOP/s float32 peak, which the 3xTF32 kernel beats
    flops, nbytes = yardstick.k3_tf32x3_work(512 * 512, 512)
    assert yardstick.bound_s(flops, nbytes, "tf32") == pytest.approx(
        flops / 495e12)
    assert flops / 495e12 < 2.95 < flops / 3 / 67e12


def test_dual_mlp_macs_from_the_widths():
    lr = 321 * 1024 + 1024 * 512 + (512 + 321) * 256 + (256 + 321) * 128 \
        + (128 + 321) * 1
    hr = 322 * 1024 + 1024 * 512 + (512 + 322) * 256 + (256 + 322) * 128 \
        + (128 + 322) * 1
    assert yardstick.dual_mlp_macs() == lr + hr


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]
    assert yardstick.union_s(iv) == 3.0
    assert yardstick.gaps(iv, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0),
                                             (4.0, 5.0)]


class _Run:
    def __init__(self, trace, out, config):
        self.out = {"trace": trace, **out}
        self.config = config


def _fast_trace(kernel, calls, work_s, window=(0.0, 10.0)):
    """A trace whose kernels run exactly their least time."""
    ops = [(kernel, "kernel", i * 0.5, i * 0.5 + work_s / calls)
           for i in range(calls)]
    return Trace(ops, [], window)


def test_shares_stay_at_or_below_100_on_synthetic_traces():
    keys = ("fused_dual_mlp_wgmma_kernel",)
    q = 1_400_000
    flops, nbytes = yardstick.k1_work(q, "bfloat16")
    least = yardstick.bound_s(flops, nbytes, "bfloat16")
    for calls in (1, 28):
        tr = _fast_trace(keys[0], calls, least)

        def cost(c):
            return flops, nbytes + (c - 1) * 0, "bfloat16"
        share = work.kernel_share(_Run(tr, {}, {}), keys, cost)
        assert share == pytest.approx(100.0)
        slow = _fast_trace(keys[0], calls, 2 * least)
        assert work.kernel_share(_Run(slow, {}, {}), keys, cost) \
            == pytest.approx(50.0)
    # idle share and busy time
    tr = _fast_trace("k", 4, 1.0)
    assert 0.0 <= tr.busy_s() <= tr.window_s
    # mfu: the least time of the window's work over a window that holds
    # it can not pass 100 %
    config = {"model": {"dtype": "bfloat16", "feature_dtype": "bfloat16",
                        "loadSize": 512, "hg_dim": 256, "num_stack_lr": 3,
                        "resolution": 512}}
    run = _Run(None, {"stats": {"mode": "octree-mono", "queries": q},
                      "subjects": 1, "window_s": 1.0}, config)
    least_s = work.serve_least_s(run)
    assert 0.0 < least_s < 1.0
    run.out["window_s"] = least_s
    assert yardstick.share_pct(least_s, run.out["window_s"]) \
        == pytest.approx(100.0)


def test_a_reader_with_nothing_to_read_returns_nothing():
    assert yardstick.share_pct(1.0, 0.0) is None
    assert work.kernel_share(_Run(Trace([], [], (0.0, 1.0)), {}, {}),
                             ("x",), lambda c: (1.0, 1.0, "tf32")) is None
