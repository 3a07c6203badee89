"""Kernel K2's plain version, its autograd op and the fused train step
(surs_tpu_torch/ops/fused_mlp.py, train/fused_step.py) against the JAX
package on the CPU: the XLA twin ``fused_dual_mlp_train_xla``, the
Pallas kernel in interpret mode, ``jax.vjp`` of the twin, and the JAX
fused step. The CUDA kernel itself is held to the plain version on the
card by chip_smoke.py.

Tolerances: float32 on both sides. Forward values agree to rtol 1e-5,
atol 1e-6 (the same products summed in another order). A gradient entry
sums its products over the N points, with cancellation, so its error is
held to its tensor's scale: rtol 1e-4 and atol 1e-4 * max|gradient|.
One SGD(1.0) step's parameters agree to rtol 2e-4 and atol 2e-6 (the
tolerances of tests/test_fused_train.py, which compares two XLA programs)
times max(1, max|parameter|): across the two frameworks a gradient sums
in another order, and some updated parameters reach |p| ~ 10."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from surs_tpu.models import SuRSNet as FlaxSuRSNet
from surs_tpu.ops import fused_mlp as jfm
from surs_tpu.train.fused_step import make_fused_train_step as jax_fused
from surs_tpu.train.step import create_train_state as jax_create_state
from surs_tpu_torch.compat.flax_import import (flax_to_state_dict,
                                               load_flax_params)
from surs_tpu_torch.config import SuRSConfig
from surs_tpu_torch.data.loader import collate
from surs_tpu_torch.models.surface_classifier import SurfaceClassifier
from surs_tpu_torch.models.surs_net import SuRSNet
from surs_tpu_torch.ops import fused_mlp as fm
from surs_tpu_torch.train import loop, optim
from surs_tpu_torch.train.fused_step import make_fused_train_step
from surs_tpu_torch.train.step import create_train_state, make_train_step

torch.set_num_threads(1)
DIMS_LR = (321, 1024, 512, 256, 128, 1)
DIMS_HR = (322, 1024, 512, 256, 128, 1)
B, S, N = 1, 16, 96
CALIB = np.diag([2.0, -2.0, 2.0, 1.0]).astype(np.float32)


def mlp_params(dims, rng, scale):
    """Flax-layout params of a SurfaceClassifier (res layers 2, 3, 4)."""
    out = {}
    for i in range(len(dims) - 1):
        d_in = dims[i] + (dims[0] if i in (2, 3, 4) else 0)
        out[f"conv{i}"] = {
            "kernel": (scale / np.sqrt(d_in) * rng.standard_normal(
                (d_in, dims[i + 1]))).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(dims[i + 1])).astype(
                np.float32)}
    return out


@pytest.fixture(scope="module")
def k2_case():
    rng = np.random.default_rng(7)
    # weights large enough that the outputs spread over (0, 1)
    p_lr = mlp_params(DIMS_LR, rng, 2.0)
    p_hr = mlp_params(DIMS_HR, rng, 2.0)
    xa = rng.standard_normal((N, 321)).astype(np.float32)
    xb = rng.standard_normal((N, 321)).astype(np.float32)
    mask = (rng.random(N) > 0.3).astype(np.float32)
    assert (mask == 0).any()
    mlp_lr = load_flax_params(SurfaceClassifier(DIMS_LR), p_lr)
    mlp_hr = load_flax_params(SurfaceClassifier(DIMS_HR), p_hr)
    return p_lr, p_hr, xa, xb, mask, mlp_lr, mlp_hr


def jax_weights(p_lr, p_hr):
    return jfm.prepare_fused_weights(p_lr, p_hr, DIMS_LR, DIMS_HR)


def test_k2_plain_matches_xla_twin_and_pallas(k2_case):
    p_lr, p_hr, xa, xb, mask, mlp_lr, mlp_hr = k2_case
    jw = jax_weights(p_lr, p_hr)
    args = (jnp.asarray(xa), jnp.asarray(xb), jnp.asarray(mask))
    twin = jfm.fused_dual_mlp_train_xla(*args, jw)
    pallas = jfm.fused_dual_mlp_train(*args, jw, block_n=128, interpret=True)
    fw = fm.prepare_fused_weights(mlp_lr, mlp_hr)
    got = fm.fused_dual_mlp_train(torch.from_numpy(xa), torch.from_numpy(xb),
                                  torch.from_numpy(mask), fw)
    assert fm.fused_dual_mlp_train.launches == 0
    for want in (twin, pallas):
        for g, w in zip(got, want):
            assert tuple(g.shape) == (N,)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-6)
    hr, lr = (g.numpy() for g in got)
    assert lr.min() < 0.2 and lr.max() > 0.8    # a spread, unmasked
    assert hr.min() < 0.2 and hr.max() > 0.8


def test_k2_mask_conditions_only_the_fine_chain(k2_case):
    _, _, xa, xb, mask, mlp_lr, mlp_hr = k2_case
    fw = fm.prepare_fused_weights(mlp_lr, mlp_hr)
    t = [torch.from_numpy(a) for a in (xa, xb)]
    hr1, lr1 = fm.fused_dual_mlp_train_ref(*t, torch.from_numpy(mask), fw)
    hr0, lr0 = fm.fused_dual_mlp_train_ref(*t, torch.ones(N), fw)
    torch.testing.assert_close(lr1, lr0, rtol=0, atol=0)
    on = torch.from_numpy(mask) > 0
    torch.testing.assert_close(hr1[on], hr0[on], rtol=0, atol=0)
    assert (hr1[~on] != hr0[~on]).all()


def test_k2_autograd_matches_jax_vjp(k2_case):
    p_lr, p_hr, xa, xb, mask, mlp_lr, mlp_hr = k2_case
    rng = np.random.default_rng(8)
    g_hr = rng.standard_normal(N).astype(np.float32)
    g_lr = rng.standard_normal(N).astype(np.float32)

    def f(xa, xb, p_lr, p_hr):
        return jfm.fused_dual_mlp_train_xla(xa, xb, jnp.asarray(mask),
                                            jax_weights(p_lr, p_hr))

    want_out, vjp = jax.vjp(f, jnp.asarray(xa), jnp.asarray(xb),
                            jax.tree_util.tree_map(jnp.asarray, p_lr),
                            jax.tree_util.tree_map(jnp.asarray, p_hr))
    dxa, dxb, dp_lr, dp_hr = vjp((jnp.asarray(g_hr), jnp.asarray(g_lr)))

    op = fm.make_fused_dual_mlp_train_ad()
    txa = torch.from_numpy(xa.copy()).requires_grad_()
    txb = torch.from_numpy(xb.copy()).requires_grad_()
    tmask = torch.from_numpy(mask.copy()).requires_grad_()
    for m in (mlp_lr, mlp_hr):
        m.zero_grad(set_to_none=True)
    out = op(txa, txb, tmask, mlp_lr, mlp_hr)
    for g, w in zip(out, want_out):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-6)
    torch.autograd.backward(out, (torch.from_numpy(g_hr),
                                  torch.from_numpy(g_lr)))
    assert tmask.grad is None

    def close(got, want, name):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)

    close(txa.grad, dxa, "xa")
    close(txb.grad, dxb, "xb")
    for mlp, dp in ((mlp_lr, dp_lr), (mlp_hr, dp_hr)):
        want_sd = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, dp))
        for name, p in mlp.named_parameters():
            close(p.grad, want_sd[name], name)


def test_k2_wrapper_checks_inputs(k2_case):
    _, _, xa, xb, mask, mlp_lr, mlp_hr = k2_case
    fw = fm.prepare_fused_weights(mlp_lr, mlp_hr)
    t = torch.from_numpy(xa)
    with pytest.raises(ValueError, match="do not make"):
        fm.fused_dual_mlp_train(t, t[:, :100], torch.ones(N), fw)
    meta = torch.empty((N, 321), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fm.fused_dual_mlp_train(meta, meta, torch.empty(N, device="meta"),
                                fw)


# ------------------------------------------------------------ fused step ---
def make_batch():
    rng = np.random.default_rng(3)
    return {
        "images_lr": rng.standard_normal((B, S, S, 3)).astype(np.float32),
        "images_hr": rng.standard_normal(
            (B, 2 * S, 2 * S, 3)).astype(np.float32),
        "points_lr": ((rng.random((B, 3, N)) - 0.5) * 1.4).astype(
            np.float32),
        "points_hr": ((rng.random((B, 3, N)) - 0.5) * 1.4).astype(
            np.float32),
        "calibs": np.tile(CALIB, (B, 1, 1)),
        "labels_lr": rng.random((B, N, 1)).astype(np.float32),
        "labels_hr": (rng.random((B, N, 1)) > 0.5).astype(np.float32),
    }


@pytest.fixture(scope="module")
def step_case():
    batch = make_batch()
    model = FlaxSuRSNet(load_size=32, num_stack_lr=2)
    opt = optax.sgd(1.0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    state = jax_create_state(model, opt, jax.random.PRNGKey(0), jb)
    step = jax_fused(model, opt, block_n=128, interpret=True, donate=False)
    new, metrics = step(state, jb)
    tree = jax.tree_util.tree_map(np.asarray, (state.params, new.params,
                                               metrics))
    return batch, tree


def close_params(got, want, name):
    want = want.numpy()
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4,
                               atol=2e-6 * max(1.0, np.abs(want).max()),
                               err_msg=name)


def port_step(params, batch, fused: bool):
    net = load_flax_params(SuRSNet(load_size=32, num_stack_lr=2), params)
    opt = optim.make_optimizer(SuRSConfig(optimizer="SGD", momentum=0.0,
                                          learning_rate=1.0),
                               net.parameters())
    st = create_train_state(net, opt)
    make = make_fused_train_step if fused else make_train_step
    return make(net, opt)(st, {k: torch.from_numpy(v.copy())
                               for k, v in batch.items()})


@pytest.mark.parametrize("fused", [True, False])
def test_port_steps_match_jax_fused_step(step_case, fused):
    """The port's fused step (K2's op; its plain version on the CPU) and
    its plain step against the JAX fused step in interpret mode."""
    batch, (params, want_params, want_m) = step_case
    st, m = port_step(params, batch, fused)
    assert st.step == 1
    for k in ("mlp1", "mlp2", "sr", "disp", "total"):
        np.testing.assert_allclose(m[k].item(), float(want_m[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for k in ("pred_hr", "pred_lr"):
        assert tuple(m[k].shape) == (B, N, 1)
        np.testing.assert_allclose(m[k].numpy(), want_m[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    want_sd = flax_to_state_dict(want_params)
    got_sd = st.model.state_dict()
    assert sorted(got_sd) == sorted(want_sd)
    for k, w in want_sd.items():
        close_params(got_sd[k], w, k)


def test_fused_step_matches_port_plain_step(step_case):
    batch, (params, _, _) = step_case
    sf, mf = port_step(params, batch, True)
    sp, mp = port_step(params, batch, False)
    for k in ("mlp1", "mlp2", "sr", "disp", "total", "pred_hr", "pred_lr"):
        np.testing.assert_allclose(mf[k].numpy(), mp[k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    psd = sp.model.state_dict()
    for k, v in sf.model.state_dict().items():
        close_params(v, psd[k], k)


@pytest.mark.parametrize("norm,views", [("batch", 1), ("group", 2)])
def test_fused_step_refuses_what_it_cannot_fuse(norm, views):
    model = types.SimpleNamespace(norm=norm, num_views=views)
    with pytest.raises(ValueError, match="make_train_step"):
        make_fused_train_step(model, None)


def test_cpu_train_takes_the_plain_step(tmp_path, monkeypatch):
    """--fused_train on the CPU takes the plain step, as the JAX loop
    does on its CPU backend."""
    import surs_tpu_torch.train.fused_step as fs

    def refuse(*a, **k):
        raise AssertionError("the fused step was built on the CPU")

    monkeypatch.setattr(fs, "make_fused_train_step", refuse)
    rng = np.random.default_rng(0)
    items = [{"img_LR": rng.standard_normal((S, S, 3)).astype(np.float32),
              "img_HR": rng.standard_normal((2 * S, 2 * S, 3)).astype(
                  np.float32),
              "calib": CALIB,
              "samples_LR": rng.uniform(-0.5, 0.5, (3, 8)).astype(np.float32),
              "samples_HR": rng.uniform(-0.5, 0.5, (3, 8)).astype(np.float32),
              "labels_disp": rng.random((1, 8)).astype(np.float32),
              "labels_HR": rng.random((1, 8)).astype(np.float32)}
             for _ in range(2)]
    cfg = SuRSConfig(loadSize=32, num_stack_lr=1, fused_train=True,
                     no_gen_mesh=True, freq_save_ply=0,
                     checkpoints_path=str(tmp_path / "c"),
                     results_path=str(tmp_path / "r"))
    out = loop.train(cfg, [collate(items)], max_iters=1, device="cpu")
    assert out["iters"] == 1
