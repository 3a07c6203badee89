"""Checkpoints into the port (surs_tpu_torch/compat/torch_import.py,
train/checkpoint.py:load_model_state, SuRSService) against the JAX
package's import (``surs_tpu.compat.import_torch_state_dict``,
``load_params``).

A reference-style state dict is synthesized from
``tests/fixtures/ref_netG_state_spec.json`` (every key and shape the
reference's SuRSNet emits at the README config, dead parameters
included), seeded. At full width, without a forward pass, the port's
import equals the JAX import followed by the weight bridge exactly
(the same float32 values, transposed twice). At tiny widths the service
loaded from the file gives the JAX service's fields within
tests/test_torch_pipeline.py's tolerance (atol 1e-4: float32 encode and
MLP in another summation order) and the same OBJ pair up to the 4
decimals and the meshes' conditioning; a ``netG_latest`` written by the
port's ``train()`` loads back exactly."""

import dataclasses
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from surs_tpu.compat import import_torch_state_dict as j_import
from surs_tpu.config import SuRSConfig as JConfig
from surs_tpu.models import SuRSNet as FlaxSuRSNet
from surs_tpu.recon.mesh_io import load_obj as j_load_obj
from surs_tpu.serve import SuRSService as JService
from surs_tpu_torch.compat.flax_import import flax_to_state_dict
from surs_tpu_torch.compat.torch_import import (import_torch_state_dict,
                                                load_netG,
                                                reference_to_flax)
from surs_tpu_torch.config import SuRSConfig
from surs_tpu_torch.data.loader import DataLoader
from surs_tpu_torch.models.surs_net import SuRSNet
from surs_tpu_torch.ops.fused_mlp import prepare_fused_weights
from surs_tpu_torch.recon.mesh_io import load_obj
from surs_tpu_torch.serve import SuRSService
from surs_tpu_torch.train.checkpoint import load_model_state
from surs_tpu_torch.train.loop import train

torch.set_num_threads(1)
SPEC_PATH = os.path.join(os.path.dirname(__file__), "fixtures",
                         "ref_netG_state_spec.json")
S = 16
# the reference's README config (residual SR bodies, as the fixture) at
# tiny widths: one lr stack, loadSize 32, a 32^3 grid
TINY = dict(loadSize=32, num_stack_lr=1, resolution=32,
            octree_init_resolution=8, num_samples=4096, residual=True,
            b_min=[-0.5, -0.5, -0.5], b_max=[0.5, 0.5, 0.5],
            mask_prune=True, dtype="float32", feature_dtype="float32",
            seed=2)
# the fixture's lr stacks past the first, absent at num_stack_lr=1
EXTRA_STACKS = re.compile(
    r"^image_filter_lr\.(m|top_m_|conv_last|bn_end|l|bl|al)[12]\.")


def load_spec(one_stack=False):
    with open(SPEC_PATH) as f:
        spec = json.load(f)
    if one_stack:
        spec = {k: v for k, v in spec.items() if not EXTRA_STACKS.match(k)}
    return spec


def synthetic_sd(spec, seed=7, scale=0.05):
    """A seeded reference-style state dict: zero-mean weights whose
    occupancy field at tiny widths crosses 0.5 without saturating."""
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32) * scale)
        for k, shape in spec.items()}


def subject():
    rng = np.random.default_rng(0)
    img = (rng.random((S, S, 3)) * 255).astype(np.uint8)
    yy, xx = np.mgrid[:S, :S]
    mask = (((xx - S / 2) / (S * 0.3)) ** 2 + ((yy - S / 2) / (S * 0.42)) ** 2
            < 1).astype(np.uint8) * 255
    return img, mask


# ------------------------------------------------------------ full width ---
def test_full_width_import_equals_jax_exactly():
    spec = load_spec()
    sd = {k: v.numpy() for k, v in synthetic_sd(spec).items()}
    model = FlaxSuRSNet(residual=True, load_size=512)
    img = jax.ShapeDtypeStruct((1, 256, 256, 3), jnp.float32)
    img_hr = jax.ShapeDtypeStruct((1, 512, 512, 3), jnp.float32)
    pts = jax.ShapeDtypeStruct((1, 3, 8), jnp.float32)
    calib = jax.ShapeDtypeStruct((1, 4, 4), jnp.float32)
    shapes = jax.eval_shape(
        lambda k, a, b, p, q, c: model.init(k, a, b, p, q, c, train=True),
        jax.random.PRNGKey(0), img, img_hr, pts, pts, calib)["params"]
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    j_params, j_n = j_import(sd, zeros, strict=False)
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, j_params))

    net = SuRSNet(residual=True, load_size=512)
    with torch.no_grad():
        for p in net.parameters():
            p.zero_()
    n = import_torch_state_dict(sd, net)
    assert n == j_n == len(want)
    got = net.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_dead_and_unknown_keys_are_skipped():
    net = SuRSNet(load_size=32, num_stack_lr=1)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    sd = {"image_filter_hr.conv1.weight": np.zeros((64, 3, 7, 7), np.float32),
          "super_resolution.sub_mean.weight": np.zeros((3, 3, 1, 1),
                                                       np.float32),
          "image_filter_lr.m2.b1_1.conv1.weight": np.zeros(
              (128, 256, 3, 3), np.float32),
          "image_filter_lr.m0.b1_1.bn1.num_batches_tracked": np.asarray(3)}
    assert import_torch_state_dict(sd, net) == 0
    for k, v in net.state_dict().items():
        assert torch.equal(v, before[k])


def test_batch_norm_running_stats_raise_naming_a16():
    """Running statistics are read since ROADMAP.md A16: into a
    batch-norm model's ``bn`` module as Flax's ``mean``; a group-norm
    model has no place for them and skips them."""
    sd = {"image_filter_lr.m0.b1_2.bn1.running_mean":
          np.arange(256, dtype=np.float32)}
    tree, n = reference_to_flax(sd, SuRSNet(load_size=32, num_stack_lr=1,
                                            norm="batch"))
    assert n == 1
    np.testing.assert_array_equal(
        tree["image_filter_lr"]["m0"]["b1_2"]["bn1"]["bn"]["mean"],
        sd["image_filter_lr.m0.b1_2.bn1.running_mean"])
    assert reference_to_flax(sd, SuRSNet(load_size=32, num_stack_lr=1)) \
        == ({}, 0)


def test_shape_mismatch_raises():
    net = SuRSNet(load_size=32, num_stack_lr=1)
    sd = {"mlp_lr.conv0.weight": np.zeros((1024, 300, 1), np.float32)}
    with pytest.raises(ValueError, match="shape mismatch"):
        import_torch_state_dict(sd, net)


# ------------------------------------------------------------ tiny width ---
@pytest.fixture(scope="module")
def ref_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "ref_netG")
    torch.save(synthetic_sd(load_spec(one_stack=True)), path)
    return path


@pytest.fixture(scope="module")
def services(ref_file):
    jsvc = JService(JConfig(serve_octree_mode="mono", mc_backend="device",
                            mc_algorithm="cubes",
                            load_netG_checkpoint_path=ref_file, **TINY),
                    compilation_cache=False)
    tsvc = SuRSService(SuRSConfig(load_netG_checkpoint_path=ref_file,
                                  **TINY), device="cpu")
    return jsvc, tsvc


def nearest_gap(a, b):
    return cKDTree(b).query(a)[0].max()


def test_reference_file_covers_the_tiny_model(ref_file, capsys):
    net = SuRSNet(load_size=32, num_stack_lr=1, residual=True)
    cfg = SuRSConfig(load_netG_checkpoint_path=ref_file, **TINY)
    n = load_netG(cfg, net)
    assert n == len(net.state_dict())        # no leaf left at random
    assert f"imported {n} tensors from torch checkpoint" in \
        capsys.readouterr().out


def test_service_from_reference_file_matches_jax(services):
    jsvc, tsvc = services
    img, mask = subject()
    want = jsvc.fields(img, mask)
    got = tsvc.fields(img, mask)
    for g, w in zip(got, want):
        g = g.numpy()
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4)
        inside = g[g > 0]
        # the weights make a field that crosses 0.5 and is not saturated
        assert inside.min() < 0.5 < inside.max() < 0.9


def test_obj_pair_from_reference_file_matches_jax(services, tmp_path):
    jsvc, tsvc = services
    img, mask = subject()
    want = jsvc.reconstruct(img, mask, "subj", str(tmp_path / "jax"))
    got = tsvc.reconstruct(img, mask, "subj", str(tmp_path / "torch"))
    for g, w in zip(got, want):
        vg, fg = load_obj(g)
        vw, fw = j_load_obj(w)
        assert fg.shape[0] > 0 and fg.shape == fw.shape
        assert vg.shape == vw.shape
        # the fields agree to an ulp, but a vertex on an edge whose two
        # values differ by ~1e-5 moves by ulp / 1e-5 of a cell (1/32):
        # 3e-4 here; 1e-3 is 3 % of a cell
        assert max(nearest_gap(vg, vw), nearest_gap(vw, vg)) < 1e-3


def test_kernel_weights_are_packed_after_loading(services):
    _, tsvc = services
    fresh = prepare_fused_weights(tsvc.model.mlp_lr, tsvc.model.mlp_hr,
                                  dtype=torch.float32)
    for name in ("w_lr", "b_lr", "w_hr", "b_hr"):
        assert torch.equal(getattr(tsvc.weights, name), getattr(fresh, name))


def test_params_and_checkpoint_together_raise(ref_file):
    with pytest.raises(ValueError, match="not both"):
        SuRSService(SuRSConfig(load_netG_checkpoint_path=ref_file, **TINY),
                    params={"mlp_lr": {}}, device="cpu")


def test_orbax_directory_raises_naming_a17(tmp_path):
    d = tmp_path / "netG_latest"
    d.mkdir()
    with pytest.raises(NotImplementedError, match="A17"):
        SuRSService(SuRSConfig(load_netG_checkpoint_path=str(d), **TINY),
                    device="cpu")


def test_no_checkpoint_keeps_the_seeded_weights(capsys):
    a = SuRSService(SuRSConfig(**TINY), device="cpu")
    assert "WARNING: no checkpoint given" in capsys.readouterr().out
    b = SuRSService(SuRSConfig(**TINY), device="cpu")
    for k, v in a.model.state_dict().items():
        assert torch.equal(b.model.state_dict()[k], v)


# --------------------------------------------------- the port's netG files ---
def train_items(n_items=2):
    rng = np.random.default_rng(4)
    calib = np.diag([2.0, -2.0, 2.0, 1.0]).astype(np.float32)
    n = 32
    return [{"name": f"s{i}",
             "img_LR": rng.standard_normal((S, S, 3)).astype(np.float32),
             "img_HR": rng.standard_normal((2 * S, 2 * S, 3)).astype(
                 np.float32),
             "calib": calib,
             "samples_LR": ((rng.random((3, n)) - 0.5) * 1.4).astype(
                 np.float32),
             "samples_HR": ((rng.random((3, n)) - 0.5) * 1.4).astype(
                 np.float32),
             "labels_disp": (rng.random((1, n)) > 0.5).astype(np.float32),
             "labels_HR": (rng.random((1, n)) > 0.5).astype(np.float32),
             "b_min": np.full(3, -0.5), "b_max": np.full(3, 0.5)}
            for i in range(n_items)]


def test_trained_netG_latest_loads_into_the_service(tmp_path):
    cfg = SuRSConfig(num_sample_inout=32, batch_size=2, freq_plot=1,
                     freq_save=50, freq_save_ply=0, num_epoch=1,
                     no_gen_mesh=True, checkpoints_path=str(tmp_path / "ck"),
                     results_path=str(tmp_path / "res"), name="t", **TINY)
    train(cfg, DataLoader(train_items(), batch_size=2, shuffle=False),
          max_iters=1, device="cpu")
    path = str(tmp_path / "ck" / "t" / "netG_latest")
    state, blob = load_model_state(path)
    assert blob is not None and blob["step"] == 1
    svc = SuRSService(dataclasses.replace(
        cfg, load_netG_checkpoint_path=path), device="cpu")
    got = svc.model.state_dict()
    assert sorted(got) == sorted(state)
    for k, v in state.items():
        assert torch.equal(got[k], v), k
    # trained, so not the seeded weights the service starts from
    seeded = SuRSService(cfg, device="cpu").model.state_dict()
    assert any(not torch.equal(seeded[k], v) for k, v in state.items())
    img, mask = subject()
    assert all(bool(torch.isfinite(f).all()) for f in svc.fields(img, mask))


def test_reference_file_is_a_bare_state_dict(ref_file):
    state, blob = load_model_state(ref_file)
    assert blob is None and "mlp_lr.conv0.weight" in state
