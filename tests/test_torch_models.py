"""The port's models (surs_tpu_torch/models) against the Flax modules of
the JAX package, with the same weights through the bridge and the same
numpy inputs. Float32 at atol 1e-4: tens of stacked convolutions and
GroupNorms in a different summation order."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from surs_tpu.models import HGFilter as FlaxHGFilter
from surs_tpu.models import SuRSNet as FlaxSuRSNet
from surs_tpu.models import SuRSSR as FlaxSuRSSR
from surs_tpu_torch.compat.flax_import import load_flax_params
from surs_tpu_torch.models.hourglass import HGFilter
from surs_tpu_torch.models.sr_net import SuRSSR
from surs_tpu_torch.models.surs_net import SuRSNet

torch.set_num_threads(1)
S = 16
CALIB = np.diag([2.0, -2.0, 2.0, 1.0]).astype(np.float32)[None]


@pytest.fixture(scope="module")
def flax_params():
    net = FlaxSuRSNet(load_size=32, num_stack_lr=2)
    img = jnp.zeros((1, S, S, 3))
    img_hr = jnp.zeros((1, 2 * S, 2 * S, 3))
    pts = jnp.zeros((1, 3, 4))
    params = net.init(jax.random.PRNGKey(3), img, img_hr, pts, pts,
                      jnp.asarray(CALIB), train=True)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(5).standard_normal(
        (1, S, S, 3)).astype(np.float32)


def _close(got, want, atol=1e-4):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=1e-4, atol=atol)


def test_sr_net_matches_flax(flax_params, image):
    p = flax_params["super_resolution"]
    want = FlaxSuRSSR().apply({"params": p}, jnp.asarray(image))
    net = load_flax_params(SuRSSR(), p)
    with torch.no_grad():
        got = net(torch.from_numpy(image))
    for g, w, shape in zip(got, want, [(1, 32, 32, 3), (1, 8, 8, 256),
                                       (1, 32, 32, 64)]):
        assert tuple(g.shape) == shape
        _close(g.numpy(), w)


@pytest.mark.parametrize("mode", ["low_res", "high_res"])
def test_hgfilter_matches_flax(flax_params, mode):
    rng = np.random.default_rng(7)
    if mode == "low_res":
        p = flax_params["image_filter_lr"]
        flax = FlaxHGFilter(2, 2, 256, "group", "low_res")
        net = HGFilter(2, 2, 256, 256, "group", "low_res")
        x = rng.standard_normal((1, 8, 8, 256)).astype(np.float32)
    else:
        p = flax_params["image_filter_hr"]
        flax = FlaxHGFilter(1, 2, 64, "group", "high_res")
        net = HGFilter(1, 2, 64, 64, "group", "high_res")
        x = rng.standard_normal((1, 32, 32, 64)).astype(np.float32)
    want = flax.apply({"params": p}, jnp.asarray(x))
    load_flax_params(net, p)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g.numpy(), w)


@pytest.fixture(scope="module")
def encoded(flax_params, image):
    flax = FlaxSuRSNet(load_size=32, num_stack_lr=2)
    want = flax.apply({"params": flax_params}, jnp.asarray(image),
                      method=FlaxSuRSNet.encode)
    net = load_flax_params(SuRSNet(load_size=32, num_stack_lr=2),
                           flax_params).eval()
    with torch.no_grad():
        got = net.encode(torch.from_numpy(image))
    return flax, want, net, got


def test_surs_net_encode_matches_flax(encoded):
    _, (w_sr, w_lr, w_hr), _, (g_sr, g_lr, g_hr) = encoded
    assert len(g_lr) == len(w_lr) == 1
    _close(g_sr.numpy(), w_sr)
    _close(g_lr[-1].numpy(), w_lr[-1])
    _close(g_hr.numpy(), w_hr)


def test_surs_net_query_matches_flax(flax_params, encoded):
    flax, (_, w_lr, w_hr), net, _ = encoded
    rng = np.random.default_rng(9)
    # points past the +-0.5 box project outside the image: masked to 0
    pts = rng.uniform(-0.6, 0.6, (1, 3, 200)).astype(np.float32)
    want_hr, want_lr = flax.apply({"params": flax_params}, w_lr, w_hr,
                                  jnp.asarray(pts), jnp.asarray(CALIB),
                                  method=FlaxSuRSNet.query)
    with torch.no_grad():
        got_hr, got_lr = net.query(
            [torch.from_numpy(np.array(w_lr[-1]))],
            torch.from_numpy(np.array(w_hr)), torch.from_numpy(pts),
            torch.from_numpy(CALIB))
    assert (got_hr.numpy() == 0).any() and (got_hr.numpy() > 0).any()
    np.testing.assert_allclose(got_hr.numpy(), np.asarray(want_hr),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_lr.numpy(), np.asarray(want_lr),
                               rtol=1e-5, atol=1e-6)


def test_bf16_trunk_matches_flax(flax_params, image):
    """bf16 conv trunk on both sides. Both round every activation to
    bf16 (8 significant bits, relative step 2^-8) but at different
    points (Flax keeps GroupNorm statistics and bias adds in its own
    order), so the features agree to a few bf16 steps of their scale:
    atol 0.05 * max|feature|."""
    flax = FlaxSuRSNet(load_size=32, num_stack_lr=2, dtype="bfloat16")
    want = flax.apply({"params": flax_params}, jnp.asarray(image),
                      method=FlaxSuRSNet.encode)
    net = load_flax_params(SuRSNet(load_size=32, num_stack_lr=2),
                           flax_params)
    net.set_trunk_dtype(torch.bfloat16).eval()
    with torch.no_grad():
        got = net.encode(torch.from_numpy(image))
    for g, w in ((got[1][-1], want[1][-1]), (got[2], want[2])):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=0.05 * np.abs(w).max())
