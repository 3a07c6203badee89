"""Multi-view training (``num_views`` > 1) and the training loop and
CLIs over the rest of SuRSNet's configuration space (batch norm, remat)
in the port, against the JAX package on the CPU, with the same weights
through the bridge and the same numpy inputs. Tolerances and helpers as
tests/test_torch_configs.py: the classifier and a step's losses and
predictions at rtol 1e-5, atol 1e-6; a step's update per tensor within
max(STEP_TOL, 2 x spread) of its norm.

The JAX package's multi-view model trains one item at a time (its views
as the rows; a batch of two items fails at the in-image mask's
broadcast) and cannot serve (its classifier averages views that one
image does not have); the port keeps both failures (ROADMAP.md C7)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from surs_tpu.config import SuRSConfig as JConfig
from surs_tpu.models import SuRSNet as FlaxSuRSNet
from surs_tpu.models import SurfaceClassifier as FlaxClassifier
from surs_tpu.serve import SuRSService as JService
from surs_tpu.train.loop import train as j_train
from surs_tpu_torch.apps import eval_surs, train_surs
from surs_tpu_torch.compat.flax_import import load_flax_params
from surs_tpu_torch.config import SuRSConfig
from surs_tpu_torch.models.surface_classifier import SurfaceClassifier
from surs_tpu_torch.models.surs_net import surs_net_from_config
from surs_tpu_torch.serve import SuRSService
from surs_tpu_torch.train import loop as train_loop
from test_torch_configs import (FWD, N, assert_metrics_close,
                                assert_step_close, jax_step, make_batch,
                                port_net, port_step, seeded_variables,
                                step_spread, subject, to_jax, to_torch)
from test_torch_dataset import render_tiny_dataset

torch.set_num_threads(1)


# ------------------------------------------------------------- multi-view ---
def test_surface_classifier_num_views_matches_flax():
    """Two views: averaged after layer n_layers // 2 = 2 (which still
    concatenates the per-view input); layers 3 and 4 concatenate the
    view-mean input."""
    dims, rows = (21, 32, 24, 16, 8, 1), 4
    x = np.random.default_rng(4).standard_normal(
        (rows, N, dims[0])).astype(np.float32)
    flax = FlaxClassifier(dims, num_views=2)
    params = seeded_variables(flax, jnp.asarray(x))["params"]
    want = flax.apply({"params": params}, jnp.asarray(x))
    net = load_flax_params(SurfaceClassifier(dims, num_views=2), params)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert tuple(got.shape) == (rows // 2, N, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


@pytest.fixture(scope="module")
def mv():
    state, batch, new, metrics = jax_step(rows=2, items=1, seed=5,
                                          num_views=2)
    return state, batch, new, metrics, step_spread(state, batch,
                                                   num_views=2)


def test_multi_view_step_matches_jax(mv):
    """num_views=2 at batch 1: predictions [2, N, 1] (each view's mask on
    the view-averaged MLP output), losses and one step's parameters."""
    state, batch, new, want_m, spread = mv
    before, after, m = port_step(port_net(state, num_views=2), batch)
    assert tuple(m["pred_hr"].shape) == (2, N, 1) == want_m["pred_hr"].shape
    assert_metrics_close(m, want_m)
    assert_step_close(before, after, new, spread)


def test_multi_view_batch_two_fails_as_in_jax(mv):
    state = mv[0]
    batch = make_batch(seed=6, rows=4, items=2)
    model = FlaxSuRSNet(load_size=32, num_stack_lr=1, num_views=2)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax.eval_shape(lambda v, b: model.apply(v, train=True, **b),
                       {"params": state.params}, to_jax(batch))
    net = port_net(state, num_views=2)
    with pytest.raises(ValueError, match="one item at a time"):
        net(train=True, **to_torch(batch))


def test_multi_view_service_fails_as_in_jax():
    common = dict(loadSize=32, num_stack_lr=1, resolution=32, num_views=2,
                  dtype="float32", feature_dtype="float32")
    with pytest.raises(TypeError, match="reshape"):
        JService(JConfig(**common), compilation_cache=False)
    with pytest.raises(ValueError, match="no multi-view serving"):
        SuRSService(SuRSConfig(**common), device="cpu")




# ---------------------------------------------------------------- the loop ---
@pytest.mark.parametrize("kw,fused", [({}, True), ({"norm": "batch"}, False),
                                      ({"num_views": 2}, False)])
def test_fused_train_gate(kw, fused):
    """--fused_train takes K2 on the card only where the JAX loop takes
    its fused step (surs_tpu/train/loop.py:116-118)."""
    cfg = SuRSConfig(fused_train=True, **kw)
    assert train_loop.fused_step_applies(cfg, torch.device("cuda")) is fused
    assert not train_loop.fused_step_applies(cfg, torch.device("cpu"))


@pytest.fixture(scope="module")
def dataroot(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mv_data"))
    render_tiny_dataset(root)
    return root


def tiny_flags(dataroot, tmp_path):
    """A tiny net on the rendered dataset (batch 1), its epoch meshes at
    32^3: config fields."""
    return {"dataroot": dataroot, "loadSize": 32, "num_stack_lr": 1,
            "num_sample_inout": 32, "sigma": 0.05, "batch_size": 1,
            "num_epoch": 1, "freq_plot": 1, "freq_save_ply": 0,
            "resolution": 32, "octree_init_resolution": 8,
            "num_samples": 4096, "b_min": [-1.0] * 3, "b_max": [1.0] * 3,
            "seed": 2, "name": "t", "checkpoints_path": str(tmp_path / "ck"),
            "results_path": str(tmp_path / "res")}


def mv_flags(dataroot, tmp_path, *extra):
    """The port's train CLI's argv for ``tiny_flags``, on the CPU, the
    dataset's yaws 0 and 180, and ``extra``."""
    argv = ["--device", "cpu", "--yaw_list", "0", "180"]
    for k, v in tiny_flags(dataroot, tmp_path).items():
        argv += [f"--{k}"] + ([str(x) for x in v] if isinstance(v, list)
                              else [str(v)])
    return argv + list(extra)


def test_multi_view_train_cli_as_jax(dataroot, tmp_path, monkeypatch,
                                     capsys):
    """The JAX train(cfg) at num_views=2, batch 1, on this dataset trains
    its 4 steps and fails in the epoch meshes, after the epoch's
    checkpoint. The port's train CLI does the same, and with
    --no_gen_mesh trains the 4 steps ([2, N, 1] predictions, finite
    losses); --fused_train on the card would take the plain step
    (test_fused_train_gate)."""
    jcfg = JConfig(**tiny_flags(dataroot, tmp_path / "jax"), num_views=2)
    with pytest.raises(ValueError):
        j_train(jcfg, yaw_list=[0, 180])
    out = capsys.readouterr().out
    # the log is lagged one step: 3 lines for 4 steps
    assert out.count("Name: t | Epoch: 0 |") == 3
    assert "generate mesh (test)" in out
    assert os.path.isdir(tmp_path / "jax" / "ck" / "t" / "netG_latest")

    with pytest.raises(ValueError, match="no multi-view serving"):
        train_surs.main(mv_flags(dataroot, tmp_path / "g", "--num_views",
                                 "2"))
    assert os.path.isfile(tmp_path / "g" / "ck" / "t" / "netG_latest")

    steps = []
    real = train_loop.make_train_step

    def counting(model, optimizer):
        step = real(model, optimizer)

        def run(state, batch):
            state, m = step(state, batch)
            steps.append((tuple(m["pred_hr"].shape), float(m["total"])))
            return state, m
        return run

    monkeypatch.setattr(train_loop, "make_train_step", counting)
    out = train_surs.main(mv_flags(dataroot, tmp_path, "--num_views", "2",
                                   "--no_gen_mesh"))
    assert out["iters"] == 4
    assert [s for s, _ in steps] == [(2, N, 1)] * 4
    assert np.isfinite([t for _, t in steps]).all()


def test_batch_norm_remat_cli_round_trip(dataroot, tmp_path, monkeypatch):
    """--norm batch --remat --remat_encoder through the train CLI (the
    model it builds has them), then the eval CLI serving its
    netG_latest with the statistics."""
    built = []
    monkeypatch.setattr(train_loop, "surs_net_from_config",
                        lambda *a: built.append(surs_net_from_config(*a))
                        or built[-1])
    flags = ["--norm", "batch", "--remat", "--remat_encoder",
             "--batch_size", "2", "--no_gen_mesh"]
    out = train_surs.main(mv_flags(dataroot, tmp_path, *flags))
    assert out["iters"] == 2
    assert [(m.norm, m.remat, m.remat_encoder) for m in built] == [
        ("batch", True, True)]
    ckpt = str(tmp_path / "ck" / "t" / "netG_latest")
    img_dir = tmp_path / "evaldata"
    for sub in ("image_final", "mask_final"):
        os.makedirs(img_dir / sub)
    img, mask = subject()
    Image.fromarray(img).save(str(img_dir / "image_final" / "a.png"))
    Image.fromarray(mask).save(str(img_dir / "mask_final" / "a.png"))
    eval_surs.main(["--device", "cpu", "--dataroot", str(img_dir),
                    "--name", "e", "--loadSize", "32", "--num_stack_lr",
                    "1", "--resolution", "32", "--octree_init_resolution",
                    "8", "--num_samples", "4096", "--norm", "batch",
                    "--b_min", "-0.5", "-0.5", "-0.5", "--b_max", "0.5",
                    "0.5", "0.5", "--load_netG_checkpoint_path", ckpt,
                    "--results_path", str(tmp_path / "eres")])
    objs = sorted(os.listdir(tmp_path / "eres" / "e"))
    assert objs == ["a_HR.obj", "a_LR.obj"]
