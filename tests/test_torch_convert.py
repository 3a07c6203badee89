"""The weight bridge (surs_tpu_torch/compat/flax_import.py): every leaf
of a Flax SuRSNet params tree lands in the port's state_dict with the
right layout, and strict loading raises on leftovers and gaps."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from surs_tpu.models import SuRSNet as FlaxSuRSNet
from surs_tpu_torch.compat.flax_import import (flax_to_state_dict,
                                               load_flax_params)
from surs_tpu_torch.models.surs_net import SuRSNet

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def flax_params():
    net = FlaxSuRSNet(load_size=32, num_stack_lr=2)
    S = 16
    img = jnp.zeros((1, S, S, 3))
    img_hr = jnp.zeros((1, 2 * S, 2 * S, 3))
    pts = jnp.zeros((1, 3, 4))
    calib = jnp.asarray(np.diag([2.0, -2.0, 2.0, 1.0]), jnp.float32)[None]
    params = net.init(jax.random.PRNGKey(0), img, img_hr, pts, pts, calib,
                      train=True)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_every_leaf_maps_to_one_parameter(flax_params):
    net = SuRSNet(load_size=32, num_stack_lr=2)
    sd = flax_to_state_dict(flax_params)
    assert len(sd) == len(list(_leaves(flax_params)))
    assert set(sd) == set(net.state_dict())
    n_flax = sum(v.size for _, v in _leaves(flax_params))
    assert n_flax == sum(p.numel() for p in net.parameters())


@pytest.mark.parametrize("path,key", [
    (("super_resolution", "head", "conv", "kernel"),
     "super_resolution.head.conv.weight"),
    (("image_filter_lr", "m0", "b2_plus_1", "conv1", "kernel"),
     "image_filter_lr.m0.b2_plus_1.conv1.weight"),
    (("image_filter_lr", "conv2", "bn3", "gn", "bias"),
     "image_filter_lr.conv2.bn3.gn.bias"),
    (("image_filter_hr", "conv5", "kernel"), "image_filter_hr.conv5.weight"),
    (("mlp_hr", "conv2", "kernel"), "mlp_hr.conv2.weight"),
    (("image_filter_lr", "bn_end1", "gn", "scale"),
     "image_filter_lr.bn_end1.gn.weight"),
    (("mlp_lr", "conv4", "bias"), "mlp_lr.conv4.bias"),
])
def test_leaf_layouts(flax_params, path, key):
    leaf = flax_params
    for p in path:
        leaf = leaf[p]
    got = flax_to_state_dict(flax_params)[key].numpy()
    if leaf.ndim == 4:
        want = leaf.transpose(3, 2, 0, 1)     # [kh,kw,in,out] -> OIHW
    elif leaf.ndim == 2:
        want = leaf.T                          # Dense [in,out] -> [out,in]
    else:
        want = leaf
    np.testing.assert_array_equal(got, want)


def test_load_is_exact(flax_params):
    net = load_flax_params(SuRSNet(load_size=32, num_stack_lr=2),
                           flax_params)
    w = flax_params["mlp_lr"]["conv2"]["kernel"]
    np.testing.assert_array_equal(net.mlp_lr.conv2.weight.detach().numpy(),
                                  w.T)


def test_strict_load_raises_on_leftover_leaf(flax_params):
    extra = dict(flax_params)
    extra["mlp_lr"] = dict(flax_params["mlp_lr"])
    extra["mlp_lr"]["conv9"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(RuntimeError, match="conv9"):
        load_flax_params(SuRSNet(load_size=32, num_stack_lr=2), extra)


def test_strict_load_raises_on_missing_leaf(flax_params):
    short = dict(flax_params)
    short["image_filter_hr"] = {}
    with pytest.raises(RuntimeError, match="conv5"):
        load_flax_params(SuRSNet(load_size=32, num_stack_lr=2), short)


def test_topology_mismatch_raises(flax_params):
    with pytest.raises(RuntimeError):
        load_flax_params(SuRSNet(load_size=32, num_stack_lr=1), flax_params)
