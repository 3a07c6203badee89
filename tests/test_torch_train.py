"""The port's training path (surs_tpu_torch/train, data/loader.py and
SuRSNet's training forward) against the JAX package on the CPU, with the
same weights through the bridge and the same numpy inputs.

Tolerances: the optimizers run the same float32 element-wise rules, so
5 steps agree to rtol 1e-6, atol 1e-7 (an ulp or two per operation).
The float32 forward agrees to rtol 1e-5, atol 1e-6; one SGD(1.0) step
moves every parameter by its gradient, which sums over the batch in
another order, so the updated parameters agree to rtol 2e-4, atol 2e-6
(the tolerances of tests/test_fused_train.py)."""

import dataclasses
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from surs_tpu.config import SuRSConfig as JaxConfig
from surs_tpu.models import SuRSNet as FlaxSuRSNet
from surs_tpu.recon.mesh_io import save_samples_truncted_prob as jax_ply
from surs_tpu.train import losses as jax_losses
from surs_tpu.train import optim as jax_optim
from surs_tpu.train.loop import batch_host_arrays as jax_batch_host_arrays
from surs_tpu.train.step import create_train_state as jax_create_state
from surs_tpu.train.step import make_train_step as jax_make_train_step
from surs_tpu_torch.compat.flax_import import (flax_to_state_dict,
                                               load_flax_params)
from surs_tpu_torch.config import SuRSConfig
from surs_tpu_torch.data import loader as port_loader
from surs_tpu_torch.data.loader import DataLoader, collate
from surs_tpu_torch.models.surs_net import SuRSNet
from surs_tpu_torch.recon.mesh_io import save_samples_truncted_prob
from surs_tpu_torch.train import losses, optim
from surs_tpu_torch.train.checkpoint import CheckpointManager
from surs_tpu_torch.train import loop as train_loop
from surs_tpu_torch.train.loop import batch_host_arrays, train
from surs_tpu_torch.train.step import (create_train_state,
                                       denormalize_images,
                                       make_eval_loss_step, make_train_step)

torch.set_num_threads(1)
B, S, N = 2, 16, 32
CALIB = np.diag([2.0, -2.0, 2.0, 1.0]).astype(np.float32)


def make_batch(seed=3, b=B, n=N):
    rng = np.random.default_rng(seed)
    return {
        "images_lr": rng.standard_normal((b, S, S, 3)).astype(np.float32),
        "images_hr": rng.standard_normal(
            (b, 2 * S, 2 * S, 3)).astype(np.float32),
        # +-0.7 reaches past the image: some points are masked out
        "points_lr": ((rng.random((b, 3, n)) - 0.5) * 1.4).astype(
            np.float32),
        "points_hr": ((rng.random((b, 3, n)) - 0.5) * 1.4).astype(
            np.float32),
        "calibs": np.tile(CALIB, (b, 1, 1)),
        "labels_lr": rng.random((b, n, 1)).astype(np.float32),
        "labels_hr": (rng.random((b, n, 1)) > 0.5).astype(np.float32),
    }


def to_torch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def batch():
    return make_batch()


@pytest.fixture(scope="module")
def jax_state(batch):
    """Flax params from a seeded init and the JAX SGD(1.0) state."""
    model = FlaxSuRSNet(load_size=32, num_stack_lr=2)
    opt = optax.sgd(1.0)
    state = jax_create_state(model, opt, jax.random.PRNGKey(0),
                             {k: jnp.asarray(v) for k, v in batch.items()})
    return model, opt, state


def port_net(params, dtype=torch.float32):
    net = load_flax_params(SuRSNet(load_size=32, num_stack_lr=2), params)
    return net.set_trunk_dtype(dtype)


def sgd_one(model):
    cfg = SuRSConfig(optimizer="SGD", momentum=0.0, learning_rate=1.0)
    return optim.make_optimizer(cfg, model.parameters())


# ----------------------------------------------------------- optimizers ---
GRADS = [{k: np.random.default_rng(10 + i).standard_normal(s).astype(
    np.float32) for k, s in (("a", (4, 5)), ("b", (7,)))} for i in range(5)]
PARAMS0 = {k: np.random.default_rng(1).standard_normal(s).astype(np.float32)
           for k, s in (("a", (4, 5)), ("b", (7,)))}


@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
@pytest.mark.parametrize("kind", ["SGD", "ADAM", "RMSprop", "AMSgrad"])
def test_optimizer_matches_optax(kind, weight_decay):
    kw = dict(optimizer=kind, learning_rate=1e-2, weight_decay=weight_decay)
    opt = jax_optim.make_optimizer(JaxConfig(**kw))
    params = {k: jnp.asarray(v) for k, v in PARAMS0.items()}
    st = opt.init(params)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in PARAMS0.items()}
    topt = optim.make_optimizer(SuRSConfig(**kw), list(tparams.values()))
    for g in GRADS:
        upd, st = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                             st, params)
        params = optax.apply_updates(params, upd)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        topt.step()
    for k, p in tparams.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_optimizer_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown optimizer"):
        optim.OptaxOptimizer([torch.nn.Parameter(torch.zeros(2))], "LBFGS",
                             1e-3)


def test_lr_schedule_and_set_learning_rate():
    for epoch in (0, 59, 60, 61, 80, 81, 200):
        assert optim.lr_for_epoch(0.5, epoch, [60, 80], 0.1) == \
            jax_optim.lr_for_epoch(0.5, epoch, [60, 80], 0.1)
    p = torch.nn.Parameter(torch.ones(3))
    opt = optim.make_optimizer(SuRSConfig(optimizer="SGD", momentum=0.0,
                                          learning_rate=1.0), [p])
    assert optim.set_learning_rate(opt, 0.25) is opt
    assert [g["lr"] for g in opt.param_groups] == [0.25]
    p.grad = torch.full((3,), 2.0)
    opt.step()
    np.testing.assert_array_equal(p.detach().numpy(), [0.5, 0.5, 0.5])


# --------------------------------------------------------------- losses ---
@pytest.mark.parametrize("name", ["mse", "l1", "bce", "custom_bce",
                                  "custom_mse", "custom_bce_masked",
                                  "custom_mse_masked"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(4)
    pred = rng.random((3, 50)).astype(np.float32)
    target = (rng.random((3, 50)) > 0.4).astype(np.float32)
    mask = (rng.random((3, 50)) > 0.3).astype(np.float32)
    fn = name.replace("_masked", "")
    kw = {"gamma": 0.7} if fn.startswith("custom") else {}
    if name.endswith("_masked"):
        kw_j, kw_t = dict(kw, mask=jnp.asarray(mask)), dict(
            kw, mask=torch.from_numpy(mask))
    else:
        kw_j = kw_t = kw
    want = getattr(jax_losses, fn)(jnp.asarray(pred), jnp.asarray(target),
                                   **kw_j)
    got = getattr(losses, fn)(torch.from_numpy(pred),
                              torch.from_numpy(target), **kw_t)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_gradient_penalty_linear_discriminator():
    """For D(x) = <w, x> the input gradient is w at every interpolate, so
    the penalty lambda * (||w|| - 1)^2 does not depend on the draws; its
    gradient with respect to w (through create_graph) is compared too."""
    rng = np.random.default_rng(6)
    real = rng.standard_normal((4, 3, 5)).astype(np.float32)
    fake = rng.standard_normal((4, 3, 5)).astype(np.float32)
    w = (0.2 * rng.standard_normal((15,))).astype(np.float32)

    def jax_pen(w):
        return jax_losses.gradient_penalty(
            lambda x: x.reshape(x.shape[0], -1) @ w, jnp.asarray(real),
            jnp.asarray(fake), jax.random.PRNGKey(0))

    want, want_g = jax.value_and_grad(jax_pen)(jnp.asarray(w))
    tw = torch.from_numpy(w.copy()).requires_grad_()
    gen = torch.Generator().manual_seed(0)
    got = losses.gradient_penalty(lambda x: x.reshape(x.shape[0], -1) @ tw,
                                  torch.from_numpy(real),
                                  torch.from_numpy(fake), gen)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want_g),
                               rtol=1e-5, atol=1e-7)


def test_ply_dump_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    pts = rng.standard_normal((20, 3)).astype(np.float32)
    prob = rng.random((20, 1)).astype(np.float32)
    save_samples_truncted_prob(str(tmp_path / "a.ply"), pts, prob)
    jax_ply(str(tmp_path / "b.ply"), pts, prob)
    assert (tmp_path / "a.ply").read_bytes() == \
        (tmp_path / "b.ply").read_bytes()


# ------------------------------------------------------ training forward ---
def test_training_forward_matches_flax(jax_state, batch):
    model, _, state = jax_state
    params = to_numpy(state.params)
    want_hr, want_total, want_lr, want_err = model.apply(
        {"params": state.params}, train=True,
        **{k: jnp.asarray(v) for k, v in batch.items()})
    net = port_net(params)
    with torch.no_grad():
        got_hr, got_total, got_lr, got_err = net(train=True,
                                                 **to_torch(batch))
    assert tuple(got_hr.shape) == (B, N, 1) == tuple(got_lr.shape)
    # masked points (outside the image) predict exactly 0
    assert (got_hr.numpy() == 0).any() and (got_hr.numpy() > 0).any()
    for g, w in ((got_hr, want_hr), (got_lr, want_lr)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    assert sorted(got_err) == sorted(want_err)
    for k in want_err:
        np.testing.assert_allclose(got_err[k].item(), float(want_err[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert got_total is got_err["total"]


def test_encode_train_keeps_every_stack(jax_state, batch):
    net = port_net(to_numpy(jax_state[2].params))
    with torch.no_grad():
        _, feats_train, _ = net.encode(torch.from_numpy(batch["images_lr"]),
                                       train=True)
        _, feats_eval, _ = net.encode(torch.from_numpy(batch["images_lr"]))
    assert len(feats_train) == 2 and len(feats_eval) == 1
    torch.testing.assert_close(feats_train[-1], feats_eval[0])


def test_eval_loss_step_matches_flax(jax_state, batch):
    model, _, state = jax_state
    want = model.apply({"params": state.params}, train=False,
                       **{k: jnp.asarray(v) for k, v in batch.items()})[3]
    got = make_eval_loss_step(port_net(to_numpy(state.params)))(
        to_torch(batch))
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


# ------------------------------------------------------------ plain step ---
@pytest.fixture(scope="module")
def jax_stepped(jax_state, batch):
    model, opt, state = jax_state
    step = jax_make_train_step(model, opt, donate=False)
    new, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    return to_numpy(new.params), to_numpy(metrics)


def test_plain_step_matches_jax(jax_state, jax_stepped, batch):
    _, _, state = jax_state
    want_params, want_m = jax_stepped
    net = port_net(to_numpy(state.params))
    st = create_train_state(net, sgd_one(net))
    st, m = make_train_step(net, st.optimizer)(st, to_torch(batch))
    assert st.step == 1
    for k in ("mlp1", "mlp2", "sr", "disp", "total"):
        np.testing.assert_allclose(m[k].item(), float(want_m[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    for k in ("pred_hr", "pred_lr"):
        np.testing.assert_allclose(m[k].numpy(), want_m[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    want_sd = flax_to_state_dict(want_params)
    got_sd = st.model.state_dict()
    assert sorted(want_sd) == sorted(got_sd)
    for k, w in want_sd.items():
        np.testing.assert_allclose(got_sd[k].numpy(), w.numpy(), rtol=2e-4,
                                   atol=2e-6, err_msg=k)


def test_bf16_trunk_step_matches_jax(jax_state, jax_stepped, batch):
    """bf16 trunk on both sides, float32 master parameters. Both round
    every conv input, weight and output and every GroupNorm output to
    bf16 (8 significant bits), at slightly different places. The losses
    agree to 1e-4 relative. The gradients of the trunk pass through
    bf16 activations, so bf16 alone moves a parameter's update (its
    gradient under SGD(1.0)) by up to ~30 % of its norm: JAX's bf16 step
    is that far from JAX's float32 step. The port's bf16 update must lie
    within twice that distance (+1 % of the norm) of JAX's bf16 update,
    tensor by tensor; a wrong gradient path would miss by 100 %."""
    model, opt, state = jax_state
    m16 = FlaxSuRSNet(load_size=32, num_stack_lr=2, dtype="bfloat16")
    new, want_m = jax_make_train_step(m16, opt, donate=False)(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    p0 = flax_to_state_dict(to_numpy(state.params))
    want_sd = flax_to_state_dict(to_numpy(new.params))
    f32_sd = flax_to_state_dict(jax_stepped[0])
    net = port_net(to_numpy(state.params), torch.bfloat16)
    st = create_train_state(net, sgd_one(net))
    st, m = make_train_step(net, st.optimizer)(st, to_torch(batch))
    for k in ("mlp1", "mlp2", "sr", "disp", "total"):
        np.testing.assert_allclose(m[k].item(), float(want_m[k]),
                                   rtol=1e-4, err_msg=k)
    got_sd = st.model.state_dict()
    for k, w in want_sd.items():
        assert got_sd[k].dtype == torch.float32
        d_want = w - p0[k]
        scale = float(d_want.norm())
        port_err = float((got_sd[k] - w).norm())
        bf16_err = float((f32_sd[k] - w).norm())
        assert port_err <= 2.0 * bf16_err + 0.01 * scale, (
            k, port_err / max(scale, 1e-30), bf16_err / max(scale, 1e-30))


# ------------------------------------------------------- host batch path ---
def raw_batch(rng, b=1, s=8, n=4, quant_edges=True):
    k = rng.integers(0, 256, (b, s, s, 3))
    img = (k / 255.0 * 2.0 - 1.0).astype(np.float32)
    if quant_edges:
        img[0, :4, :4, :] = 0.0          # mask-multiplied background
        img[0, 4, 4, :] = [-1.0, 0.0, 1.0]
    return {"img_LR": img, "img_HR": img.copy(),
            "calib": np.tile(np.eye(4, dtype=np.float32), (b, 1, 1)),
            "samples_LR": rng.standard_normal((b, 3, n)).astype(np.float32),
            "samples_HR": rng.standard_normal((b, 3, n)).astype(np.float32),
            "labels_disp": rng.random((b, 1, n)).astype(np.float32),
            "labels_HR": rng.random((b, 1, n)).astype(np.float32)}


def test_uint8_wire_format_matches_jax():
    raw = raw_batch(np.random.default_rng(0))
    host = batch_host_arrays(raw, quantize_images=True)
    want = jax_batch_host_arrays(raw, quantize_images=True)
    assert sorted(host) == sorted(want)
    for k in want:
        assert host[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(host[k], want[k], err_msg=k)
    assert host["images_lr"].dtype == np.uint8
    assert host["labels_hr"].shape == (1, 4, 1)
    d = denormalize_images({k: torch.from_numpy(v.copy())
                            for k, v in host.items()})["images_lr"].numpy()
    np.testing.assert_allclose(d, raw["img_LR"], atol=0.5 / 127.0)
    np.testing.assert_array_equal(d[0, :4, :4, :], 0.0)
    np.testing.assert_array_equal(d[0, 4, 4, :], [-1.0, 0.0, 1.0])


def test_multiview_reshape_matches_jax():
    rng = np.random.default_rng(1)
    raw = raw_batch(rng, b=2, quant_edges=False)
    raw = {k: (np.stack([v, v + 1], axis=1) if k in ("img_LR", "img_HR",
                                                     "calib") else v)
           for k, v in raw.items()}
    host = batch_host_arrays(raw)
    want = jax_batch_host_arrays(raw)
    assert host["images_lr"].shape == (4, 8, 8, 3)
    for k in want:
        np.testing.assert_array_equal(host[k], want[k], err_msg=k)


# ---------------------------------------------------------------- loader ---
ITEMS = [{"x": np.full((2, 2), i, np.float32), "name": str(i)}
         for i in range(10)]


@pytest.mark.parametrize("threads", [1, 2])
def test_loader_batching(threads):
    dl = DataLoader(ITEMS, batch_size=4, shuffle=False, num_threads=threads,
                    prefetch=2)
    batches = list(dl)
    assert len(dl) == len(batches) == 2
    assert batches[0]["x"].shape == (4, 2, 2)
    assert batches[0]["name"] == ["0", "1", "2", "3"]
    assert collate(ITEMS[:2])["name"] == ["0", "1"]


def test_loader_spawn_workers_match_single_process():
    kw = dict(batch_size=4, shuffle=True, seed=12)
    ref = list(DataLoader(ITEMS, **kw))
    dl = DataLoader(ITEMS, num_workers=2, mp_context="spawn", **kw)
    try:
        got = list(dl)
    finally:
        dl.close()
    assert len(got) == len(ref) == 2
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a["x"], b["x"])
        assert a["name"] == b["name"]


def test_loader_falls_back_to_spawn_after_cuda_init(monkeypatch):
    monkeypatch.setattr(port_loader, "_fork_hazardous", lambda: True)
    with pytest.warns(UserWarning, match="spawn"):
        dl = DataLoader(ITEMS, batch_size=5, shuffle=False, num_workers=1)
    try:
        assert len(list(dl)) == 2
    finally:
        dl.close()


_WORKER_SCRIPT = r"""
import json, os, sys
import numpy as np
import torch
from surs_tpu_torch.data.loader import DataLoader

class Probe:
    def __len__(self):
        return 6
    def __getitem__(self, i):
        return {"i": np.array(i), "pid": os.getpid(),
                "cvd": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "cuda_init": torch.cuda.is_initialized()}

dl = DataLoader(Probe(), batch_size=2, shuffle=False, num_workers=2)
out = [{k: (v.tolist() if hasattr(v, "tolist") else v)
        for k, v in b.items()} for b in dl]
dl.close()
print(json.dumps({"parent": os.getpid(), "batches": out,
                  "parent_cuda_init": torch.cuda.is_initialized()}))
"""


def test_loader_workers_never_touch_cuda():
    """Fork workers run in other processes, hide the GPUs from
    themselves before any item runs, and create no CUDA context; the
    probe runs in a fresh interpreter so that the fork happens in a
    process with no other runtime's threads."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _WORKER_SCRIPT], cwd=root,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=root))
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert [b["i"] for b in rec["batches"]] == [[0, 1], [2, 3], [4, 5]]
    for b in rec["batches"]:
        assert rec["parent"] not in b["pid"]
        assert b["cvd"] == ["", ""]
        assert b["cuda_init"] == [False, False]
    assert rec["parent_cuda_init"] is False


# ------------------------------------------------------- checkpointing ---
def test_checkpoint_roundtrip(tmp_path, jax_state, batch):
    params = to_numpy(jax_state[2].params)
    net = port_net(params)
    cfg = SuRSConfig(optimizer="ADAM", learning_rate=1e-3)
    st = create_train_state(net, optim.make_optimizer(cfg,
                                                      net.parameters()))
    st, _ = make_train_step(net, st.optimizer)(st, to_torch(batch))
    mgr = CheckpointManager(str(tmp_path), "exp")
    mgr.save(st, epoch=3)
    assert mgr.exists(3) and mgr.exists(None) and not mgr.exists(4)
    fresh = port_net(params)
    st2 = create_train_state(fresh, optim.make_optimizer(
        cfg, fresh.parameters()))
    mgr.restore(st2, epoch=3)
    assert st2.step == 1
    for k, v in st.model.state_dict().items():
        torch.testing.assert_close(st2.model.state_dict()[k], v, rtol=0,
                                   atol=0)
    # the restored optimizer continues exactly as the original
    a, _ = make_train_step(net, st.optimizer)(st, to_torch(batch))
    b, _ = make_train_step(fresh, st2.optimizer)(st2, to_torch(batch))
    for k, v in a.model.state_dict().items():
        torch.testing.assert_close(b.model.state_dict()[k], v, rtol=0,
                                   atol=0)


# ------------------------------------------------------------ train loop ---
def tiny_cfg(tmp_path, **kw):
    base = dict(loadSize=32, num_stack_lr=1, num_sample_inout=N,
                batch_size=2, learning_rate=1e-3, freq_plot=1,
                freq_save=50, freq_save_ply=0, num_epoch=1, no_gen_mesh=True,
                checkpoints_path=str(tmp_path / "ckpt"),
                results_path=str(tmp_path / "res"), name="t", seed=2)
    base.update(kw)
    return SuRSConfig(**base)


def train_items(n_items=4, seed=0):
    """Items in the training dataset's format, from a seed."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_items):
        b = make_batch(seed + i, b=1)
        out.append({"name": f"s{i}", "img_LR": b["images_lr"][0],
                    "img_HR": b["images_hr"][0], "calib": CALIB,
                    "samples_LR": b["points_lr"][0],
                    "samples_HR": b["points_hr"][0],
                    "labels_disp": b["labels_lr"][0].T,
                    "labels_HR": b["labels_hr"][0].T,
                    "b_min": np.full(3, -0.5), "b_max": np.full(3, 0.5)})
    del rng
    return out


LOG_LINE = re.compile(
    r"^Name: t \| Epoch: 0 \| 0/2 \| Err: \d+\.\d{6} \| LR: 0\.001000 \| "
    r"Sigma: 5\.00 \| dataT: \d+\.\d{5} \| netT: \d+\.\d{5} \| "
    r"ETA: \d\d:\d\d$")


@pytest.mark.parametrize("freq_save_ply", [0, 1])
def test_train_two_iterations_on_cpu(tmp_path, capsys, freq_save_ply):
    cfg = tiny_cfg(tmp_path, freq_save_ply=freq_save_ply)
    loader = DataLoader(train_items(), batch_size=2, shuffle=False)
    steps = []
    out = train(cfg, loader, max_iters=2, device="cpu",
                on_step=lambda st, m: steps.append(
                    (st.step, float(m["total"]))))
    assert out["iters"] == 2 and [s for s, _ in steps] == [1, 2]
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("Name:")]
    assert len(lines) == 1 and LOG_LINE.match(lines[0]), lines
    assert f"Err: {steps[0][1]:.06f}" in lines[0]
    ck = tmp_path / "ckpt" / "t"
    assert sorted(os.listdir(ck)) == ["netG_epoch_0", "netG_latest"]
    plys = sorted(p for p in os.listdir(tmp_path / "res" / "t")
                  if p.endswith(".ply"))
    if freq_save_ply <= 0:
        assert plys == []
    else:
        assert plys == ["0pred.ply", "0pred_gt.ply", "0pred_lr.ply"]
        head = (tmp_path / "res" / "t" / "0pred.ply").read_text()
        assert head.startswith(f"ply\nformat ascii 1.0\nelement vertex {N}")


def test_train_resumes_with_continue_train_zero(tmp_path):
    """The reference's inverted flag: continue_train == 0 resumes from
    netG_latest (resume_epoch < 0), and the step count carries on."""
    loader = DataLoader(train_items(), batch_size=2, shuffle=False)
    train(tiny_cfg(tmp_path), loader, max_iters=1, device="cpu")
    seen = []
    train(tiny_cfg(tmp_path, continue_train=0), loader, max_iters=1,
          device="cpu", on_step=lambda st, m: seen.append(st.step))
    assert seen == [2]
    seen.clear()
    train(tiny_cfg(tmp_path, continue_train=1), loader, max_iters=1,
          device="cpu", on_step=lambda st, m: seen.append(st.step))
    assert seen == [1]


def test_train_epoch_end_generates_meshes(tmp_path):
    cfg = tiny_cfg(tmp_path, no_gen_mesh=False, resolution=32,
                   octree_init_resolution=8, num_samples=4096,
                   b_min=[-0.5] * 3, b_max=[0.5] * 3)
    items = train_items()
    loader = DataLoader(items, batch_size=2, shuffle=False)
    train(cfg, loader, device="cpu", gen_items={"test": items[:1]})
    files = sorted(os.listdir(tmp_path / "res" / "t"))
    assert files == ["test_eval_epoch0_s0_HR.obj",
                     "test_eval_epoch0_s0_LR.obj"]


def test_train_without_gen_items_raises(tmp_path):
    """A given loader's epoch meshes need gen_items= (train() builds them
    from its datasets only when it builds the loader)."""
    loader = DataLoader(train_items(), batch_size=2, shuffle=False)
    with pytest.raises(ValueError, match="gen_items"):
        train(tiny_cfg(tmp_path, no_gen_mesh=False), loader, device="cpu")


# ------------------------------------------------ training from dataroot ---
@pytest.fixture(scope="module")
def dataroot(tmp_path_factory):
    """Two sphere subjects rendered at 32x32 from yaws 0 and 180 by the
    port's renderer (test_torch_dataset.render_tiny_dataset)."""
    from test_torch_dataset import render_tiny_dataset
    root = str(tmp_path_factory.mktemp("train_data"))
    render_tiny_dataset(root)
    return root


def dataroot_flags(dataroot, tmp_path):
    """A tiny net on the rendered dataset with the epoch meshes at 32^3:
    command-line flags, and the same as a config."""
    flags = {"dataroot": dataroot, "loadSize": 32, "num_stack_lr": 1,
             "num_sample_inout": 32, "sigma": 0.05, "batch_size": 2,
             "num_epoch": 1, "freq_plot": 1, "freq_save_ply": 0,
             "resolution": 32, "octree_init_resolution": 8,
             "num_samples": 4096, "name": "t", "seed": 2,
             "b_min": [-1.0] * 3, "b_max": [1.0] * 3,
             "checkpoints_path": str(tmp_path / "ckpt"),
             "results_path": str(tmp_path / "res")}
    return flags, SuRSConfig(**flags, random_flip=True, random_scale=True,
                             random_trans=True)


EPOCH_OBJS = ["test_eval_epoch0_subj0_HR.obj", "test_eval_epoch0_subj0_LR.obj",
              "train_eval_epoch0_subj0_HR.obj",
              "train_eval_epoch0_subj0_LR.obj"]


def test_train_from_dataroot_on_cpu(dataroot, tmp_path, capsys):
    """train(cfg) with no loader builds the datasets and the loader,
    trains an epoch (4 items, 2 steps) and writes the checkpoints and the
    epoch's four OBJ files, from a test item and an unaugmented train
    item."""
    _, cfg = dataroot_flags(dataroot, tmp_path)
    out = train(cfg, device="cpu", yaw_list=[0, 180])
    assert out["iters"] == 2
    assert "containment on: cpu (num_workers=0)" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / "ckpt" / "t")) == [
        "netG_epoch_0", "netG_latest"]
    assert sorted(os.listdir(tmp_path / "res" / "t")) == EPOCH_OBJS


def test_train_cli_end_to_end(dataroot, tmp_path):
    """python -m surs_tpu_torch.apps.train_surs on the CPU, with a worker
    process building the items (its containment on the CPU, printed)."""
    flags, _ = dataroot_flags(dataroot, tmp_path)
    argv = ["--device", "cpu", "--yaw_list", "0", "180", "--random_flip",
            "--num_workers", "1"]
    for k, v in flags.items():
        argv += [f"--{k}"] + ([str(x) for x in v] if isinstance(v, list)
                              else [str(v)])
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run(
        [sys.executable, "-m", "surs_tpu_torch.apps.train_surs", *argv],
        cwd=root, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=root))
    assert run.returncode == 0, run.stderr[-3000:]
    assert "containment on: cpu (num_workers=1)" in run.stdout
    assert "train data size: 2" in run.stdout
    assert sorted(os.listdir(tmp_path / "ckpt" / "t")) == [
        "netG_epoch_0", "netG_latest"]
    assert sorted(os.listdir(tmp_path / "res" / "t")) == EPOCH_OBJS


@pytest.mark.parametrize("workers,where", [(0, "cuda"), (1, "cpu")])
def test_train_containment_device_follows_the_workers(tmp_path, capsys,
                                                      monkeypatch, workers,
                                                      where):
    """On the card the containment runs on the training device without
    workers, and on the CPU with them (they hide the GPUs), said on
    stdout. The datasets are the first thing train() builds: nothing
    here touches CUDA."""
    seen = []

    class Stop(Exception):
        pass

    def dataset(cfg, phase, yaw_list=None, contains_device=None):
        seen.append(contains_device)
        raise Stop

    monkeypatch.setattr(train_loop, "TrainDataset", dataset)
    with pytest.raises(Stop):
        train(tiny_cfg(tmp_path, num_workers=workers), device="cuda")
    assert [d.type for d in seen] == [where]
    assert f"containment on: {where} (num_workers={workers})" \
        in capsys.readouterr().out


@pytest.mark.parametrize("field,value", [("remat", True),
                                         ("remat_encoder", True),
                                         ("norm", "batch")])
def test_train_unported_knobs_raise(tmp_path, field, value):
    cfg = dataclasses.replace(tiny_cfg(tmp_path), **{field: value})
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        train(cfg, [], device="cpu")


def test_train_needs_a_device_or_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: train() would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(tiny_cfg(tmp_path), [])
