"""The color branch and the legacy PIFu nets in the port
(surs_tpu_torch/models/pifu_legacy.py, train/color.py, the netC import
and the eval CLI's --with_color) against the JAX package on the CPU, with
the same weights through the bridge and the same seeded numpy inputs.
The JAX side's params are drawn from a numpy seed in the shapes of a
traced init (not compiled).

Tolerances, float32 throughout:
  * a filter or a norm-free net (convolutions and products in another
    summation order): atol 1e-5 on maps of values up to ~10, 1e-6 on
    outputs in [-1, 1], rtol 1e-5 on a classifier's raw outputs; 5e-5
    on the reference filter's map (eleven affine-free instance norms);
  * a net with the MLP's group norm (ResBlkColorNet, MLP): atol 1e-3.
    The norm's fast variance E[x^2] - E[x]^2 over a few points and
    channels cancels, and it amplifies the filters' float32 noise
    (~1e-6 relative) about a hundredfold;
  * three ResBlkColorNet steps (SGD and Adam): losses rtol 1e-4 (the
    group norm's amplified noise, above); each tensor's update within
    max(STEP_TOL, 2 x spread) of its norm (STEP_TOL below);
  * colors in [0, 1] from colorize_vertices: atol 1e-4; from the netC
    import (norm-free): atol 1e-5;
  * OBJ text: byte for byte where the inputs are equal; between the
    two CLIs, whose HR meshes are the same up to vertices moved by a
    field an ulp apart (tests/test_torch_eval.py), the colors of the
    vertices written identically agree within one last digit (1e-4)
    for the reference netC and within 2e-3 for ResBlkColorNet: its group
    norm takes statistics over a chunk of 65,536 points of which all but
    the mesh's few hundred are identical zero-padding rows, so the
    variance is small and the noise is amplified further.
"""

import json
import os
import re
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from surs_tpu.compat.torch_import import \
    import_torch_color_state_dict as j_import_color
from surs_tpu.config import SuRSConfig as JConfig
from surs_tpu.data.sampling import MeshData as JMeshData
from surs_tpu.data.sampling import sample_surface_colors as j_sample_colors
from surs_tpu.models import pifu_legacy as J
from surs_tpu.models.surface_classifier import \
    SurfaceClassifier as JSurfaceClassifier
from surs_tpu.recon.mesh_io import load_obj as j_load_obj
from surs_tpu.recon.mesh_io import save_obj_mesh_with_color as j_save_color
from surs_tpu.recon.mesh_io import save_obj_mesh_with_uv as j_save_uv
from surs_tpu.recon.mesh_io import save_samples_rgb as j_save_rgb
from surs_tpu.train import make_optimizer as j_make_optimizer
from surs_tpu.train import color as j_color
from surs_tpu_torch.apps.eval_surs import main
from surs_tpu_torch.compat.flax_import import load_flax_params
from surs_tpu_torch.compat.torch_import import (import_torch_color_state_dict,
                                                load_netC)
from surs_tpu_torch.config import SuRSConfig
from surs_tpu_torch.data.sampling import MeshData, sample_surface_colors
from surs_tpu_torch.models import pifu_legacy as P
from surs_tpu_torch.models.surface_classifier import SurfaceClassifier
from surs_tpu_torch.recon.mesh_io import (load_obj, load_obj_ref,
                                          save_obj_mesh_with_color,
                                          save_obj_mesh_with_color_ref,
                                          save_obj_mesh_with_uv,
                                          save_samples_rgb)
from surs_tpu_torch.train import color

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))
APP = os.path.join(HERE, "..", "apps", "eval_surs.py")
NETC_SPEC = os.path.join(HERE, "fixtures", "ref_netC_state_spec.json")
S = 16
CALIB = np.diag([2.0, -2.0, 2.0, 1.0]).astype(np.float32)[None]
# the tiny color MLPs: ResBlkColorNet's input is its filter's 256
# channels and the depth; RefColorNet's adds netG's map (8 channels here)
COLOR_DIMS = (257, 64, 32, 3)
REF_DIMS = (265, 32, 16, 3)
FEAT_CH = 8


def seeded_params(model, *args, seed=0, scale=0.05):
    """Flax params of ``model`` from a numpy seed in the shapes of a
    traced init: N(0, scale) kernels and biases, norm scales 1 + N(0,
    scale)."""
    shapes = jax.eval_shape(lambda k: model.init(k, *args),
                            jax.random.PRNGKey(0))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, v):
        w = rng.standard_normal(v.shape) * scale
        return (w + (path[-1].key == "scale")).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def image(seed=1, batch=1, size=S):
    return np.random.default_rng(seed).standard_normal(
        (batch, size, size, 3)).astype(np.float32)


def points(seed=2, batch=1, n=40):
    return ((np.random.default_rng(seed).random((batch, 3, n)) - 0.5)
            * 1.2).astype(np.float32)


def t(x):
    return torch.from_numpy(np.asarray(x))


# ------------------------------------------------------------- modules ---
@pytest.mark.parametrize("name", ["multiconv", "vgg16", "resnet"])
def test_backbones_match_flax(name):
    x = image(batch=2)
    jm, pm = J.BACKBONES[name](), P.BACKBONES[name]()
    params = seeded_params(jm, x)
    want = jm.apply({"params": params}, x)
    got = load_flax_params(pm, params)(t(x))
    assert len(got) == len(want) == {"multiconv": 4, "vgg16": 3,
                                     "resnet": 4}[name]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0, atol=1e-5)


@pytest.mark.parametrize("res_layers,norm,last_op", [
    ((), "group", "sigmoid"), ((1,), "group", "tanh"),
    ((1, 2), "none", "none")])
def test_mlp_matches_flax(res_layers, norm, last_op):
    dims = (64, 64, 32, 32, 3)
    x = np.random.default_rng(3).standard_normal((2, 50, 64)).astype(
        np.float32)
    jm = J.MLP(dims, res_layers=res_layers, norm=norm, last_op=last_op)
    pm = P.MLP(dims, res_layers=res_layers, norm=norm, last_op=last_op)
    params = seeded_params(jm, x)
    got = load_flax_params(pm, params)(t(x)).detach().numpy()
    np.testing.assert_allclose(got, jm.apply({"params": params}, x),
                               rtol=0, atol=1e-3 if norm == "group" else 1e-5)


@pytest.mark.parametrize("sigmoid,tanh", [(True, False), (False, True),
                                          (False, False)])
def test_surface_classifier_last_op_matches_flax(sigmoid, tanh):
    """The flags of the JAX classifier; the port's default stays the
    sigmoid."""
    dims = (20, 16, 8, 3)
    x = np.random.default_rng(4).standard_normal((2, 9, 20)).astype(
        np.float32)
    jm = JSurfaceClassifier(dims, res_layers=(1,), sigmoid=sigmoid,
                            tanh=tanh)
    pm = SurfaceClassifier(dims, res_layers=(1,), sigmoid=sigmoid,
                           tanh=tanh)
    params = seeded_params(jm, x, scale=0.5)
    got = load_flax_params(pm, params)(t(x)).detach().numpy()
    np.testing.assert_allclose(got, jm.apply({"params": params}, x),
                               rtol=1e-5, atol=1e-6)
    default = load_flax_params(SurfaceClassifier(dims, res_layers=(1,)),
                               params)
    np.testing.assert_array_equal(
        default(t(x)).detach().numpy(),
        load_flax_params(SurfaceClassifier(dims, res_layers=(1,),
                                           sigmoid=True, tanh=False),
                         params)(t(x)).detach().numpy())


@pytest.mark.parametrize("backbone,width", [("multiconv", 513),
                                            ("vgg16", 449), ("resnet", 513)])
def test_conv_pifu_net_matches_flax(backbone, width):
    """The classifier's input is as wide as the filter's maps + 1,
    whatever mlp_dim[0] says (Flax's Dense takes it from its input)."""
    x, pts = image(batch=2), points(batch=2)
    cal = np.tile(CALIB, (2, 1, 1))
    dims = (513, 32, 16, 1)
    jm = J.ConvPIFuNet(backbone=backbone, mlp_dim=dims, load_size=S)
    pm = P.ConvPIFuNet(backbone=backbone, mlp_dim=dims, load_size=S)
    params = seeded_params(jm, x, pts, cal)
    want = np.asarray(jm.apply({"params": params}, x, pts, cal))
    assert pm.surface_classifier.conv0.in_features == width
    got = load_flax_params(pm, params)(t(x), t(pts), t(cal))
    assert got.shape == want.shape == (2, 40, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6)
    assert (want == 0).any()      # points outside the image


@pytest.mark.parametrize("mode", ["orthogonal", "perspective"])
@pytest.mark.parametrize("with_transforms", [False, True])
def test_projections_match_jax(mode, with_transforms):
    """The legacy nets' projections, with the optional image-space affine;
    then ConvPIFuNet through them."""
    from surs_tpu.ops.geometry import PROJECTIONS as J_PROJECTIONS
    from surs_tpu_torch.ops.geometry import PROJECTIONS
    rng = np.random.default_rng(7)
    pts = points(batch=2)
    cal = np.tile(CALIB, (2, 1, 1))
    cal[:, 2, 3] = 3.0                 # depth 2.4-3.6: the divide is safe
    tr = (np.concatenate([np.eye(2)[None] * 0.9 + rng.normal(0, 0.05,
                                                             (2, 2, 2)),
                          rng.normal(0, 0.1, (2, 2, 1))], axis=2)
          .astype(np.float32) if with_transforms else None)
    want = np.asarray(J_PROJECTIONS[mode](pts, cal, tr))
    got = PROJECTIONS[mode](t(pts), t(cal),
                            None if tr is None else t(tr)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    x = image(batch=2)
    jm = J.ConvPIFuNet(projection_mode=mode, mlp_dim=(513, 16, 1),
                       load_size=S)
    pm = P.ConvPIFuNet(projection_mode=mode, mlp_dim=(513, 16, 1),
                       load_size=S)
    params = seeded_params(jm, x, pts, cal)
    want = np.asarray(jm.apply({"params": params}, x, pts, cal, tr))
    got = load_flax_params(pm, params)(t(x), t(pts), t(cal),
                                       None if tr is None else t(tr))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6)


def test_vhull_net_matches_jax():
    H = W = 33
    yy, xx = np.mgrid[:H, :W]
    m = ((np.abs(xx - 16) <= 8) & (np.abs(yy - 14) <= 10)).astype(np.float32)
    masks = np.stack([m, m.T])[..., None]
    c1 = CALIB[0].copy()
    c1[:3, :3] = c1[:3, :3] @ np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0]],
                                       np.float32)
    calibs = np.stack([CALIB[0], c1])
    pts = points(seed=5, n=300)
    want = np.asarray(J.VhullNet().query(masks, pts, calibs))
    got = P.VhullNet().query(t(masks), t(pts), t(calibs)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < 300


@pytest.mark.parametrize("dims", [COLOR_DIMS, (513, 64, 32, 3)])
def test_resblk_color_net_matches_flax(dims):
    """The MLP's input is 257 wide, also under the default 513 of
    mlp_dim_color."""
    x, pts = image(batch=2), points(batch=2)
    cal = np.tile(CALIB, (2, 1, 1))
    jm = J.ResBlkColorNet(load_size=S, mlp_dim_color=dims)
    pm = P.ResBlkColorNet(load_size=S, mlp_dim_color=dims)
    assert pm.color_mlp.conv0.in_features == 257
    params = seeded_params(jm, x, pts, cal)
    want = np.asarray(jm.apply({"params": params}, x, pts, cal))
    got = load_flax_params(pm, params)(t(x), t(pts), t(cal))
    assert got.shape == want.shape == (2, 40, 3)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-3)


def test_ref_color_net_matches_flax():
    """The reference topology (reflect pads, affine-free instance norms,
    the 7x7 stem and the stride-2 3x3 convs) with netG's map sampled
    separately: the two maps differ in size."""
    x, pts = image(batch=2), points(batch=2)
    cal = np.tile(CALIB, (2, 1, 1))
    feat = np.random.default_rng(6).standard_normal(
        (2, 6, 6, FEAT_CH)).astype(np.float32)
    jm = J.RefColorNet(load_size=S, mlp_dim_color=REF_DIMS)
    pm = P.RefColorNet(load_size=S, mlp_dim_color=REF_DIMS)
    params = seeded_params(jm, x, feat, pts, cal)
    want = np.asarray(jm.apply({"params": params}, x, feat, pts, cal))
    got = load_flax_params(pm, params)(t(x), t(feat), t(pts), t(cal))
    assert got.shape == want.shape == (2, 40, 3)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6)
    own = jm.apply({"params": params}, x,
                   method=lambda m, a: m.image_filter(a))
    np.testing.assert_allclose(pm.encode(t(x)).detach().numpy(), own,
                               rtol=1e-5, atol=5e-5)


# ------------------------------------------------------------ training ---
def cube(half=0.4):
    v = np.array([[x, y, z] for x in (-half, half) for y in (-half, half)
                  for z in (-half, half)], np.float32)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    f = [tr for a, b, c, d in quads for tr in ((a, b, c), (a, c, d))]
    return v, np.array(f, np.int64)


@pytest.mark.parametrize("n,sigma", [(64, 0.0), (37, 0.05)])
def test_sample_surface_colors_matches_jax(n, sigma):
    v, f = cube()
    colors = v / 0.8 + 0.5
    want = j_sample_colors(JMeshData(v, f), colors, n, sigma,
                           np.random.default_rng(9))
    got = sample_surface_colors(MeshData(v, f), colors, n, sigma,
                                np.random.default_rng(9))
    assert sorted(got) == sorted(want) == ["color_samples", "rgbs"]
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32
        assert got[k].shape == (3, n)
        np.testing.assert_array_equal(got[k], want[k])


def color_batch(n=48):
    v, f = cube()
    out = sample_surface_colors(MeshData(v, f), v / 0.8 + 0.5, n, 0.0,
                                np.random.default_rng(4))
    return {"images": image(seed=8), "points": out["color_samples"][None],
            "calibs": CALIB, "rgbs": out["rgbs"].T[None].copy()}


# each tensor's update against JAX's: within max(STEP_TOL, 2 x spread) of
# its norm (tests/test_torch_dataset.py's rule), the spread being the
# larger of the port's own update gaps under a 1e-7 relative scaling of
# the weights, up and down: some of the MLP's norm parameters have
# gradients at the level of the group norm's amplified float32 noise, and
# Adam's first steps move a weight by about lr whatever its gradient's
# size.
STEP_TOL = 2e-3
# 4 and 2 channels a group over 128 points: a batch on which three steps
# lower the loss and the port's spread stays near 1e-6 (over 48 points
# and 2 channels a group the steps are chaotic: 1e-7 in the weights
# moves the third step's loss by 1e-2)
TRAIN_DIMS = (257, 128, 64, 3)


def color_state(params, cfg, scale=1.0):
    net = P.ResBlkColorNet(load_size=S, mlp_dim_color=TRAIN_DIMS)
    state = color.create_color_state(net, SuRSConfig(**cfg),
                                     torch.Generator().manual_seed(0), "cpu")
    load_flax_params(state.net, jax.tree_util.tree_map(
        lambda a: np.float32(scale) * a, params))
    return state


@pytest.mark.parametrize("loss_type,optimizer,lr", [
    ("l1", "SGD", 0.01), ("mse", "SGD", 0.01), ("l1", "ADAM", 1e-3)])
def test_color_train_steps_match_jax(loss_type, optimizer, lr):
    """Three steps from the same weights: the losses, and every
    parameter's update after each step."""
    batch = color_batch(128)
    cfg = dict(learning_rate=lr, optimizer=optimizer)
    jnet = J.ResBlkColorNet(load_size=S, mlp_dim_color=TRAIN_DIMS)
    params = seeded_params(jnet, batch["images"], batch["points"],
                           batch["calibs"])
    jopt = j_make_optimizer(JConfig(**cfg))
    jstate = j_color.ColorState(step=jnp.zeros((), jnp.int32), params=params,
                                opt_state=jopt.init(params))
    jstep = j_color.make_color_train_step(jnet, jopt, loss_type)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    states = [color_state(params, cfg, scale) for scale in
              (1.0, 1.0 + 1e-7, 1.0 - 1e-7)]
    starts = [{k: v.clone() for k, v in st.net.state_dict().items()}
              for st in states]
    step = color.make_color_train_step(loss_type)
    for _ in range(3):
        jstate, jloss = jstep(jstate, jbatch)
        losses = [float(step(st, batch)[1]) for st in states]
        np.testing.assert_allclose(losses[0], float(jloss), rtol=1e-4)
        want = load_flax_params(
            P.ResBlkColorNet(load_size=S, mlp_dim_color=TRAIN_DIMS),
            np_tree(jstate.params)).state_dict()
        upd = [{k: v - s0[k] for k, v in st.net.state_dict().items()}
               for st, s0 in zip(states, starts)]
        for k, w in want.items():
            spread = max(float((u[k] - upd[0][k]).norm()) for u in upd[1:])
            gap = float((upd[0][k] - (w - starts[0][k])).norm())
            bound = max(STEP_TOL * float((w - starts[0][k]).norm()),
                        2 * spread)
            assert gap <= bound, k
    assert states[0].step == 3


def test_create_color_state_initialises_from_the_generator():
    nets = [color.create_color_state(
        P.ResBlkColorNet(load_size=S, mlp_dim_color=COLOR_DIMS),
        SuRSConfig(), torch.Generator().manual_seed(s), "cpu").net
        for s in (0, 0, 1)]
    w = [n.color_mlp.conv0.weight for n in nets]
    assert torch.equal(w[0], w[1]) and not torch.equal(w[0], w[2])
    assert abs(float(w[0].detach().std()) - 0.02) < 2e-3
    assert float(nets[0].color_mlp.conv0.bias.abs().max()) == 0.0
    assert torch.equal(nets[0].image_filter.n0a.gn.weight,
                       torch.ones(128))


# ---------------------------------------------------------- colorizing ---
def test_colorize_vertices_pads_chunks_as_jax():
    """37 vertices in chunks of 16: the last chunk's 11 zero points enter
    the group norm's statistics in both packages."""
    img = image(seed=10)
    jnet = J.ResBlkColorNet(load_size=S, mlp_dim_color=COLOR_DIMS)
    params = seeded_params(jnet, img, points(n=8), CALIB, scale=0.1)
    verts = (np.random.default_rng(11).random((37, 3)) - 0.5).astype(
        np.float32)
    want = j_color.colorize_vertices(jnet, params, jnp.asarray(img), verts,
                                     jnp.asarray(CALIB), chunk=16)
    net = load_flax_params(
        P.ResBlkColorNet(load_size=S, mlp_dim_color=COLOR_DIMS), params)
    got = color.colorize_vertices(net, img, verts, CALIB, chunk=16)
    assert got.shape == want.shape == (37, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # the chunk changes the colors: the padding is in the statistics
    other = color.colorize_vertices(net, img, verts, CALIB, chunk=64)
    assert np.abs(other - got).max() > 1e-3


def test_colorize_vertices_ref_matches_jax():
    img = image(seed=12)
    feat = np.random.default_rng(13).standard_normal(
        (1, 4, 4, FEAT_CH)).astype(np.float32)
    jnet = J.RefColorNet(load_size=S, mlp_dim_color=REF_DIMS)
    params = seeded_params(jnet, img, feat, points(n=8), CALIB, scale=0.1)
    verts = (np.random.default_rng(14).random((37, 3)) - 0.5).astype(
        np.float32)
    want = j_color.colorize_vertices_ref(jnet, params, jnp.asarray(img),
                                         jnp.asarray(feat), verts,
                                         jnp.asarray(CALIB), chunk=16)
    net = load_flax_params(P.RefColorNet(load_size=S, mlp_dim_color=REF_DIMS),
                           params)
    got = color.colorize_vertices_ref(net, img, t(feat), verts, CALIB,
                                      chunk=16)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # no norm across points: the chunk moves a color by rounding only
    np.testing.assert_allclose(
        got, color.colorize_vertices_ref(net, img, t(feat), verts, CALIB,
                                         chunk=64), rtol=0, atol=1e-6)


# ------------------------------------------------------------ netC file ---
def reference_netc(dims=None, seed=11, scale=0.05):
    """A reference ResBlkPIFuNet state dict, every key of
    tests/fixtures/ref_netC_state_spec.json, the classifier at ``dims``
    (default the spec's 513-wide one), seeded."""
    with open(NETC_SPEC) as f:
        spec = json.load(f)
    if dims is not None:
        spec = {k: v for k, v in spec.items()
                if not k.startswith("surface_classifier.")}
        for i in range(len(dims) - 1):
            spec[f"surface_classifier.conv{i}.weight"] = [dims[i + 1],
                                                          dims[i], 1]
            spec[f"surface_classifier.conv{i}.bias"] = [dims[i + 1]]
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32) * scale) for k, shape in sorted(spec.items())}


def jax_ref_params(sd, net, *args):
    shapes = jax.eval_shape(lambda k: net.init(k, *args),
                            jax.random.PRNGKey(0))["params"]
    zeros = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                   shapes)
    return j_import_color(sd, zeros, strict=True)


def test_netc_import_matches_jax():
    """The spec's full-width netC (513 = 256 of netG + 256 + 1) imported
    by both packages gives the same colors."""
    sd = reference_netc()
    img = image(seed=15)
    feat = np.random.default_rng(16).standard_normal((1, 4, 4, 256)).astype(
        np.float32)
    jnet = J.RefColorNet(load_size=S)
    params, n_jax = jax_ref_params(sd, jnet, img, feat, points(n=8), CALIB)
    net = P.RefColorNet(load_size=S)
    n = import_torch_color_state_dict(sd, net)
    assert n == n_jax == 40 == len(net.state_dict())
    verts = (np.random.default_rng(17).random((50, 3)) - 0.5).astype(
        np.float32)
    want = j_color.colorize_vertices_ref(jnet, params, jnp.asarray(img),
                                         jnp.asarray(feat), verts,
                                         jnp.asarray(CALIB), chunk=64)
    got = color.colorize_vertices_ref(net, img, feat, verts, CALIB,
                                      chunk=64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert got.std() > 1e-3


@pytest.mark.parametrize("key", ["image_filter.model.2.weight",
                                 "image_filter.model.10.conv_block.3.weight",
                                 "surface_classifier.filters.0.weight",
                                 "netC.conv0.weight"])
def test_netc_import_refuses_unknown_keys(key):
    sd = reference_netc(REF_DIMS)
    sd[key] = torch.zeros(4)
    with pytest.raises(KeyError, match="unmappable netC key"):
        import_torch_color_state_dict(sd, P.RefColorNet(mlp_dim_color=REF_DIMS))
    with pytest.raises(KeyError):
        j_import_color({key: np.zeros(4, np.float32)}, {}, strict=True)


def test_netc_import_refuses_missing_and_misshapen_tensors():
    sd = reference_netc(REF_DIMS)
    del sd["image_filter.model.12.conv_block.5.bias"]
    with pytest.raises(RuntimeError, match="Missing key"):
        import_torch_color_state_dict(sd, P.RefColorNet(mlp_dim_color=REF_DIMS))
    with pytest.raises(ValueError, match="shape mismatch"):
        import_torch_color_state_dict(reference_netc(REF_DIMS),
                                      P.RefColorNet())


def test_load_netc_reads_the_three_kinds(tmp_path):
    """A reference state dict -> RefColorNet; a port ResBlkColorNet
    state_dict and a pickled JAX param tree -> ResBlkColorNet, the same
    weights."""
    cfg = dict(loadSize=S, mlp_dim_color=list(COLOR_DIMS))
    ref = str(tmp_path / "ref")
    torch.save(reference_netc([8 + 257, 32, 16, 3]), ref)
    net, is_ref = load_netC(SuRSConfig(load_netC_checkpoint_path=ref,
                                       loadSize=S,
                                       mlp_dim_color=[265, 32, 16, 3]),
                            "cpu")
    assert is_ref and isinstance(net, P.RefColorNet)
    params = seeded_params(J.ResBlkColorNet(load_size=S,
                                            mlp_dim_color=COLOR_DIMS),
                           image(), points(n=8), CALIB)
    tree = str(tmp_path / "tree")
    torch.save(np_tree(params), tree)
    port = str(tmp_path / "port")
    torch.save(load_flax_params(
        P.ResBlkColorNet(load_size=S, mlp_dim_color=COLOR_DIMS),
        params).state_dict(), port)
    loaded = [load_netC(SuRSConfig(load_netC_checkpoint_path=p, **cfg),
                        "cpu") for p in (tree, port)]
    for net, is_ref in loaded:
        assert not is_ref and isinstance(net, P.ResBlkColorNet)
    a, b = (n.state_dict() for n, _ in loaded)
    assert sorted(a) == sorted(b)
    assert all(torch.equal(a[k], b[k]) for k in a)


# ---------------------------------------------------------------- files ---
def test_colored_obj_matches_the_jax_writer(tmp_path):
    """Byte for byte, '%.4f' included on its ties (0.03125 -> 0.0312,
    -0.40625 -> -0.4062) and signs (-0.0, -1e-5), through the host
    library and through the plain version; read back with colors."""
    rng = np.random.default_rng(18)
    verts = (rng.standard_normal((300, 3)) * 0.5)
    cols = rng.random((300, 3)).astype(np.float32)
    special = [0.03125, -0.40625, -0.0, -1e-5, 0.99995, 0.00015, 1e5,
               -123456.78125, 0.5]
    verts[:len(special), 0] = special
    cols[:len(special), 2] = np.float32(special)
    faces = rng.integers(0, 300, (500, 3))
    paths = {k: str(tmp_path / f"{k}.obj") for k in ("jax", "lib", "ref")}
    j_save_color(paths["jax"], verts, faces, cols)
    save_obj_mesh_with_color(paths["lib"], verts, faces, cols)
    save_obj_mesh_with_color_ref(paths["ref"], verts, faces, cols)
    want = open(paths["jax"], "rb").read()
    assert open(paths["lib"], "rb").read() == want
    assert open(paths["ref"], "rb").read() == want
    for got, ref in zip(load_obj(paths["jax"], with_colors=True),
                        j_load_obj(paths["jax"], with_colors=True)):
        np.testing.assert_array_equal(got, ref)
    # a file without colors reads None, as JAX's
    plain = str(tmp_path / "plain.obj")
    save_obj_mesh_with_uv(plain, verts[:3], faces[:0], rng.random((3, 2)))
    assert load_obj_ref(plain, with_colors=True)[2] is None
    assert j_load_obj(plain, with_colors=True)[2] is None
    with pytest.raises(ValueError, match="colors"):
        save_obj_mesh_with_color(paths["lib"], verts, faces, cols[:5])


def test_colored_obj_near_ties_match_the_jax_writer(tmp_path):
    """Values within 1e-9 of a 4-decimal tie, and exact float32 ties,
    where the library's fast rounding hands over to snprintf: the bytes
    of the JAX package's '%.4f'."""
    rng = np.random.default_rng(21)
    k = rng.integers(-99999, 99999, 3000)
    near = (k + 0.5) / 1e4 + rng.choice([-1e-9, -1e-12, 0.0, 1e-12, 1e-9],
                                        3000)
    ties = np.float32(rng.integers(0, 2 ** 10, 3000) / 2 ** 10)
    verts = near.reshape(-1, 3)
    cols = ties.reshape(-1, 3)
    faces = np.zeros((0, 3), np.int64)
    a, b = str(tmp_path / "lib.obj"), str(tmp_path / "jax.obj")
    save_obj_mesh_with_color(a, verts, faces, cols)
    j_save_color(b, verts, faces, cols)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_uv_obj_and_rgb_ply_match_the_jax_writers(tmp_path):
    rng = np.random.default_rng(19)
    verts = rng.standard_normal((40, 3))
    faces = rng.integers(0, 40, (60, 3))
    uvs = rng.random((40, 2))
    for name, fn, jfn, args in (
            ("uv.obj", save_obj_mesh_with_uv, j_save_uv, (verts, faces, uvs)),
            ("rgb.ply", save_samples_rgb, j_save_rgb,
             (verts, rng.random((40, 3))))):
        fn(str(tmp_path / ("p" + name)), *args)
        jfn(str(tmp_path / ("j" + name)), *args)
        assert (tmp_path / ("p" + name)).read_bytes() == \
            (tmp_path / ("j" + name)).read_bytes()


# ------------------------------------------------------------- eval CLI ---
CLI_FLAGS = ["--loadSize", "32", "--num_stack_lr", "1", "--residual",
             "--resolution", "32", "--octree_init_resolution", "8",
             "--num_samples", "4096", "--seed", "2",
             "--b_min", "-0.5", "-0.5", "-0.5", "--b_max", "0.5", "0.5", "0.5",
             "--octree_mode", "mono", "--mc_backend", "device",
             "--mc_algorithm", "cubes", "--dtype", "float32",
             "--feature_dtype", "float32", "--with_color"]
NETC_DIMS = [513, 32, 16, 3]


def color_lines(path):
    """{'x y z': (r, g, b)} of a colored OBJ's vertex lines, and its face
    lines."""
    verts, faces = {}, []
    for line in open(path):
        parts = line.split()
        if parts[0] == "v":
            verts[" ".join(parts[1:4])] = tuple(float(p) for p in parts[4:])
        else:
            faces.append(line)
    return verts, faces


@pytest.mark.parametrize("kind", ["reference", "jax_tree"])
def test_cli_with_color_matches_the_jax_cli(tmp_path, monkeypatch, capsys,
                                            kind):
    """One subject through both eval CLIs with --with_color: a reference
    netC state dict (RefColorNet, netG's map attached) or a pickled JAX
    ResBlkColorNet param tree. The port's _HR_color.obj holds its _HR.obj
    vertices in order and its faces; the vertices that both CLIs wrote
    identically carry the same colors."""
    from test_torch_eval import eval_root, reference_checkpoint
    root = eval_root(tmp_path, names=("subj",))
    ckpt = reference_checkpoint(str(tmp_path / "ref_netG"))
    netc = str(tmp_path / "netC")
    if kind == "reference":
        torch.save(reference_netc(NETC_DIMS, scale=0.1), netc)
        dims = NETC_DIMS
    else:
        dims = [257, 64, 32, 3]
        torch.save(np_tree(seeded_params(
            J.ResBlkColorNet(load_size=32, mlp_dim_color=tuple(dims)),
            image(size=S), points(n=8), CALIB, scale=0.1)), netc)
    args = ["--dataroot", str(root), "--name", "ev",
            "--load_netG_checkpoint_path", ckpt,
            "--load_netC_checkpoint_path", netc, "--mlp_dim_color",
            *map(str, dims), *CLI_FLAGS]
    monkeypatch.setattr(sys, "argv", [
        "eval_surs.py", *args, "--results_path", str(tmp_path / "jax")])
    runpy.run_path(APP, run_name="__main__")
    capsys.readouterr()
    main([*args, "--results_path", str(tmp_path / "torch"), "--device",
          "cpu"])
    out = capsys.readouterr().out
    n_netc = 30 + 2 * (len(NETC_DIMS) - 1)    # the filter's, the MLP's
    assert (f"imported {n_netc} netC tensors" in out) == (kind == "reference")
    assert re.search(r"color subj: \d+ vertices, colorize", out)
    got_p = tmp_path / "torch" / "ev" / "subj_HR_color.obj"
    got, got_f = color_lines(got_p)
    want, want_f = color_lines(tmp_path / "jax" / "ev" / "subj_HR_color.obj")
    hr_v, hr_f = load_obj(str(tmp_path / "torch" / "ev" / "subj_HR.obj"))
    cv, cf, cc = load_obj(str(got_p), with_colors=True)
    np.testing.assert_array_equal(cv, hr_v)
    # the faces read from _HR.obj are written with the winding swap once
    # more, as the JAX CLI writes them
    np.testing.assert_array_equal(cf, hr_f[:, [0, 2, 1]])
    assert cc.shape == hr_v.shape and cc.min() >= 0 and cc.max() <= 1
    assert len(got_f) == len(want_f) > 0 and len(got) > 100
    both = sorted(set(got) & set(want))
    assert len(both) >= 0.9 * len(want)
    gap = max(max(abs(a - b) for a, b in zip(got[k], want[k]))
              for k in both)
    assert gap <= (1e-4 + 1e-7 if kind == "reference" else 2e-3)
    assert np.std([got[k] for k in both]) > 1e-2


def test_cli_with_color_without_netc_writes_no_color_obj(tmp_path, capsys):
    from test_torch_eval import eval_root
    root = eval_root(tmp_path, names=("subj",))
    main(["--dataroot", str(root), "--name", "ev", *CLI_FLAGS,
          "--results_path", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "no netC given" in out
    files = sorted(os.listdir(tmp_path / "ev"))
    assert files == ["subj_HR.obj", "subj_LR.obj"]


def test_cli_with_color_on_an_empty_mesh_prints_the_skip(tmp_path, capsys):
    """An all-black mask: no HR surface, the JAX CLI's skip line."""
    root = tmp_path / "data"
    for sub in ("image_final", "mask_final"):
        (root / sub).mkdir(parents=True)
    Image.fromarray(np.zeros((S, S, 3), np.uint8)).save(
        str(root / "image_final" / "e.png"))
    Image.fromarray(np.zeros((S, S), np.uint8)).save(
        str(root / "mask_final" / "e.png"))
    netc = str(tmp_path / "netC")
    torch.save(reference_netc(NETC_DIMS), netc)
    main(["--dataroot", str(root), "--name", "ev", *CLI_FLAGS,
          "--load_netC_checkpoint_path", netc, "--mlp_dim_color",
          *map(str, NETC_DIMS), "--results_path", str(tmp_path),
          "--device", "cpu"])
    out = capsys.readouterr().out
    assert "empty HR mesh for e — skip color" in out
    assert not (tmp_path / "ev" / "e_HR_color.obj").exists()
