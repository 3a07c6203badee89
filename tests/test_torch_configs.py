"""The rest of SuRSNet's configuration space in the port (batch-norm
trunks with HGFilter's conv64 stem, remat of the point MLPs and of the
encoder; multi-view training and the CLIs are in
test_torch_configs_train.py) against the JAX package on the CPU, with
the same weights and statistics through the bridge and the same numpy
inputs. The JAX side's variables are drawn from a numpy seed in the
shapes of its init (traced, not compiled).

Tolerances, float32 throughout:
  * one batch norm: the same element-wise float32 arithmetic on the same
    reductions in another order: rtol 1e-5, atol 1e-6 (outputs and
    running statistics after 1 and 3 updates);
  * a trunk or a model (tens of convolutions and norms in another
    summation order): rtol 1e-4, atol 1e-4 on outputs, as
    tests/test_torch_models.py, and on the running statistics;
  * a training forward and one SGD(1.0) step: losses and predictions at
    rtol 1e-5, atol 1e-6, as tests/test_torch_train.py; each tensor's
    update, as test_torch_dataset.py's step from the dataset, within
    max(STEP_TOL, 2 x spread) of its norm, the spread being the port's
    own update gap under a 1e-7 relative scaling of the weights: these
    batches put an MLP pre-activation within float32 noise of the
    leaky-ReLU kink (a batch norm over a few values at these widths, or
    two views of one item), and the biases in front of a batch norm have
    gradients that are float32 noise by design;
  * remat against no remat in the port: the same float32 operations,
    recomputed: losses at rtol 1e-6 and gradients at rtol 2e-5, atol
    1e-6 (tests/test_models.py's JAX remat tolerances), the running
    statistics bit for bit;
  * served fields at atol 1e-4, as tests/test_torch_pipeline.py.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from surs_tpu.compat.torch_import import \
    load_torch_checkpoint as j_load_torch_checkpoint
from surs_tpu.config import SuRSConfig as JConfig
from surs_tpu.models import HGFilter as FlaxHGFilter
from surs_tpu.models import SuRSNet as FlaxSuRSNet
from surs_tpu.models import surs_net_from_config as j_net_from_config
from surs_tpu.models.layers import Norm as FlaxNorm
from surs_tpu.serve import SuRSService as JService
from surs_tpu.train.step import TrainState as JTrainState
from surs_tpu.train.step import make_train_step as j_make_train_step
from surs_tpu_torch.compat.flax_import import (flax_to_state_dict,
                                               load_flax_params)
from surs_tpu_torch.compat.torch_import import (import_torch_state_dict,
                                                load_netG)
from surs_tpu_torch.config import SuRSConfig, resolve_config
from surs_tpu_torch.data.loader import DataLoader
from surs_tpu_torch.models.hourglass import HGFilter
from surs_tpu_torch.models.layers import Norm
from surs_tpu_torch.models.surs_net import SuRSNet, surs_net_from_config
from surs_tpu_torch.serve import SuRSService
from surs_tpu_torch.train import optim
from surs_tpu_torch.train.checkpoint import CheckpointManager
from surs_tpu_torch.train.loop import train
from surs_tpu_torch.train.step import (create_train_state,
                                       make_eval_loss_step, make_train_step)
from test_torch_dataset import STEP_TOL, update_gap

torch.set_num_threads(1)
S, N = 16, 32
CALIB = np.diag([2.0, -2.0, 2.0, 1.0]).astype(np.float32)
MODEL = dict(rtol=1e-4, atol=1e-4)
FWD = dict(rtol=1e-5, atol=1e-6)
STATS = re.compile(r"\.running_(mean|var)$")


def make_batch(seed=3, rows=2, items=None):
    """A training batch of ``rows`` image rows; with ``items`` < rows the
    labels are per item (multi-view: rows = items x views)."""
    items = rows if items is None else items
    rng = np.random.default_rng(seed)
    return {
        "images_lr": rng.standard_normal((rows, S, S, 3)).astype(np.float32),
        "images_hr": rng.standard_normal(
            (rows, 2 * S, 2 * S, 3)).astype(np.float32),
        "points_lr": np.repeat(((rng.random((items, 3, N)) - 0.5) * 1.4)
                               .astype(np.float32), rows // items, 0),
        "points_hr": np.repeat(((rng.random((items, 3, N)) - 0.5) * 1.4)
                               .astype(np.float32), rows // items, 0),
        "calibs": np.tile(CALIB, (rows, 1, 1)),
        "labels_lr": rng.random((items, N, 1)).astype(np.float32),
        "labels_hr": (rng.random((items, N, 1)) > 0.5).astype(np.float32),
    }


def to_torch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def sgd_one(model):
    cfg = SuRSConfig(optimizer="SGD", momentum=0.0, learning_rate=1.0)
    return optim.make_optimizer(cfg, model.parameters())


def stats_of(model):
    return {k: v.clone() for k, v in model.state_dict().items()
            if STATS.search(k)}


def assert_tree_close(got_sd, want_tree, tol):
    want = flax_to_state_dict(want_tree)
    assert want
    for k, w in want.items():
        np.testing.assert_allclose(got_sd[k].detach().numpy(), w.numpy(),
                                   err_msg=k, **tol)


def seeded_variables(model, *args, seed=0, **kw):
    """Flax variables of ``model`` from a numpy seed, with the shapes of
    ``model.init(key, *args, **kw)`` (traced, not compiled): kernels and
    biases N(0, 0.02), norm scales 1 + N(0, 0.02), batch statistics as
    ``perturbed_stats``."""
    shapes = jax.eval_shape(lambda k: model.init(k, *args, **kw),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(path, v):
        w = rng.standard_normal(v.shape) * 0.02
        return (w + (path[-1].key == "scale")).astype(np.float32)
    out = {"params": jax.tree_util.tree_map_with_path(draw,
                                                      shapes["params"])}
    if "batch_stats" in shapes:
        out["batch_stats"] = perturbed_stats(shapes["batch_stats"], seed)
    return out


def perturbed_stats(stats, seed=11):
    """batch_stats with means N(0, 0.1) and variances in [0.5, 2]: the
    eval path must read them, not the init's zeros and ones."""
    rng = np.random.default_rng(seed)

    def draw(path, v):
        name = path[-1].key
        if name == "mean":
            return (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
        return rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, stats)


# ------------------------------------------------------------ batch norm ---
@pytest.mark.parametrize("updates", [1, 3])
def test_batch_norm_matches_flax(updates):
    """Train-mode outputs and the running statistics after each update
    (the biased fast variance, momentum 0.9), then eval-mode outputs
    from those statistics on a module left in .train() mode."""
    rng = np.random.default_rng(updates)
    xs = [(3.0 + 2.0 * rng.standard_normal((4, 5, 6, 32))).astype(np.float32)
          for _ in range(updates + 1)]
    flax = FlaxNorm("batch")
    variables = seeded_variables(flax, jnp.asarray(xs[0]))
    norm = Norm(32, "batch").train()
    norm.bn.load_state_dict(flax_to_state_dict(
        {**to_numpy(variables["params"]["bn"]),
         **variables["batch_stats"]["bn"]}))
    for x in xs[:updates]:
        want, upd = flax.apply(variables, jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
        variables = {"params": variables["params"], **upd}
        got = norm(torch.from_numpy(x).permute(0, 3, 1, 2), train=True)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                                   np.asarray(want), **FWD)
        assert_tree_close(norm.state_dict(),
                          {"bn": to_numpy(variables["batch_stats"]["bn"])},
                          FWD)
    before = stats_of(norm)
    want = flax.apply(variables, jnp.asarray(xs[-1]), train=False)
    got = norm(torch.from_numpy(xs[-1]).permute(0, 3, 1, 2), train=False)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(want), **FWD)
    assert all(torch.equal(v, before[k]) for k, v in stats_of(norm).items())
    # torch's own running update (unbiased variance) misses by n/(n-1)
    ref = torch.nn.BatchNorm2d(32, momentum=0.1)
    ref.load_state_dict({**{k[3:]: v for k, v in before.items()},
                         "weight": norm.bn.weight, "bias": norm.bn.bias,
                         "num_batches_tracked": torch.tensor(0)})
    x = torch.from_numpy(xs[0]).permute(0, 3, 1, 2)
    ref(x)
    norm(x, train=True)
    assert not np.allclose(ref.running_var.numpy(),
                           norm.bn.running_var.numpy(), **FWD)


def test_batch_norm_state_dict_names():
    assert sorted(Norm(32, "batch").state_dict()) == [
        "bn.bias", "bn.running_mean", "bn.running_var", "bn.weight"]


def test_batch_norm_bf16_output_dtype():
    x = torch.randn(2, 32, 4, 4).to(torch.bfloat16)
    norm = Norm(32, "batch")
    assert norm(x, train=True).dtype == torch.bfloat16
    assert norm.bn.running_mean.dtype == torch.float32


# ----------------------------------------------------------------- conv64 ---
def conv64_input(seed=0):
    return np.random.default_rng(seed).standard_normal(
        (2, 16, 16, 64)).astype(np.float32)


def test_conv64_hgfilter_matches_flax():
    """One stack, batch norm: 64 -> ConvBlock(64) -> down_conv2 (128,
    stride 2) -> an hourglass whose outer blocks take 128 channels."""
    x = conv64_input()
    flax = FlaxHGFilter(1, 2, 256, "batch", "conv64")
    variables = seeded_variables(flax, jnp.asarray(x))
    net = HGFilter(1, 2, 64, 256, "batch", "conv64")
    load_flax_params(net, variables)
    assert tuple(net.m0.b1_2.conv1.weight.shape) == (128, 128, 3, 3)
    assert hasattr(net.m0.b2_2, "downsample_conv")
    want, upd = jax.jit(lambda v, x: flax.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    got = net(torch.from_numpy(x), train=True)
    assert tuple(got[0].shape) == (2, 8, 8, 256)
    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(want[0]),
                               **MODEL)
    assert_tree_close(net.state_dict(), to_numpy(upd["batch_stats"]), MODEL)
    want = jax.jit(flax.apply)({"params": variables["params"], **upd},
                               jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **MODEL)


def test_conv64_two_stacks_fail_as_in_jax():
    x = jnp.asarray(conv64_input())
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax.eval_shape(FlaxHGFilter(2, 2, 256, "batch", "conv64").init,
                       jax.random.PRNGKey(0), x)
    with pytest.raises(ValueError, match="one stack"):
        HGFilter(2, 2, 64, 256, "batch", "conv64")


def test_conv64_group_norm_fails_as_in_jax():
    """ConvBlock(64) has a 16-channel branch, which 32 groups cannot
    split (tests/test_models.py:256-266)."""
    x = jnp.asarray(conv64_input())
    with pytest.raises(ValueError, match="groups"):
        jax.eval_shape(FlaxHGFilter(1, 2, 256, "group", "conv64").init,
                       jax.random.PRNGKey(0), x)
    with pytest.raises(ValueError, match="divisible"):
        HGFilter(1, 2, 64, 256, "group", "conv64")


# --------------------------------------------------- batch-norm SuRSNet ---
def jax_step(norm="group", rows=2, items=None, seed=3, **kw):
    """A Flax SuRSNet (one lr stack), its SGD(1.0) state from
    ``seeded_variables``, a batch and one JAX plain step from the
    state."""
    batch = make_batch(seed=seed, rows=rows, items=items)
    model = FlaxSuRSNet(load_size=32, num_stack_lr=1, norm=norm, **kw)
    opt = optax.sgd(1.0)
    v = jax.tree_util.tree_map(jnp.asarray, seeded_variables(
        model, train=True, **to_jax(batch)))
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                        opt_state=opt.init(v["params"]),
                        batch_stats=v.get("batch_stats"))
    new, metrics = j_make_train_step(model, opt, donate=False)(
        state, to_jax(batch))
    return state, batch, new, to_numpy(metrics)


def port_net(state, scale=None, **kw):
    """The port model on ``state``'s weights (and statistics);
    ``scale``: a seed, to scale every weight by (1 + 1e-7 N(0, 1))."""
    params = to_numpy(state.params)
    if scale is not None:
        noise = np.random.default_rng(scale)
        params = jax.tree_util.tree_map(
            lambda w: (w * (1 + 1e-7 * noise.standard_normal(w.shape))
                       ).astype(w.dtype), params)
    if state.batch_stats is not None:
        kw["norm"] = "batch"
        params = {"params": params,
                  "batch_stats": to_numpy(state.batch_stats)}
    return load_flax_params(SuRSNet(load_size=32, num_stack_lr=1, **kw),
                            params)


def port_step(net, batch):
    """One plain SGD(1.0) step -> (weights before, state dict after,
    metrics)."""
    before = {k: v.clone() for k, v in net.state_dict().items()}
    st = create_train_state(net, sgd_one(net))
    st, m = make_train_step(net, st.optimizer)(st, to_torch(batch))
    return before, st.model.state_dict(), m


def step_spread(state, batch, **kw):
    """The port's own largest update gap (relative to the update's norm)
    between a step from the weights and one from the scaled weights."""
    a0, a1, _ = port_step(port_net(state, **kw), batch)
    b0, b1, _ = port_step(port_net(state, scale=0, **kw), batch)
    return max(update_gap(a1[k], a0[k], b1[k], b0[k], a1[k])
               for k in a1 if not STATS.search(k))


def assert_step_close(before, after, jax_new, spread):
    """Each tensor's update within max(STEP_TOL, 2 x spread) of the JAX
    update's norm; a batch-norm model's statistics at MODEL."""
    want = flax_to_state_dict(to_numpy(jax_new.params))
    assert want and not (set(want) - set(after))
    worst = max(update_gap(want[k], before[k], after[k], before[k], want[k])
                for k in want)
    assert worst <= max(STEP_TOL, 2 * spread), (worst, spread)
    if jax_new.batch_stats is not None:
        assert_tree_close(after, to_numpy(jax_new.batch_stats), MODEL)


def assert_metrics_close(got, want, keys=("mlp1", "mlp2", "sr", "disp",
                                          "total", "pred_hr", "pred_lr")):
    for k in keys:
        np.testing.assert_allclose(np.asarray(got[k]), want[k], err_msg=k,
                                   **FWD)


@pytest.fixture(scope="module")
def bn():
    state, batch, new, metrics = jax_step("batch")
    return state, batch, new, metrics, step_spread(state, batch)


def test_batch_norm_surs_net_forward_matches_flax(bn):
    """The training forward: predictions, losses and the statistics it
    moves (against the JAX step's forward)."""
    state, batch, new, want_m, _ = bn
    net = port_net(state)
    with torch.no_grad():
        hr, _, lr, errors = net(train=True, **to_torch(batch))
    assert_metrics_close({**errors, "pred_hr": hr, "pred_lr": lr}, want_m)
    assert_tree_close(net.state_dict(), to_numpy(new.batch_stats), MODEL)


def test_batch_norm_plain_step_matches_jax(bn):
    """One plain step: losses, parameters and the statistics, which move
    once."""
    state, batch, new, want_m, spread = bn
    before, after, m = port_step(port_net(state), batch)
    assert_metrics_close(m, want_m)
    assert_step_close(before, after, new, spread)


def test_batch_norm_eval_loss_step_leaves_the_statistics(bn):
    state, batch, _, _, _ = bn
    model = FlaxSuRSNet(load_size=32, num_stack_lr=1, norm="batch")
    want = jax.jit(lambda v, b: model.apply(v, train=False, **b)[3])(
        {"params": state.params, "batch_stats": state.batch_stats},
        to_jax(batch))
    net = port_net(state).train()           # left in training mode
    before = stats_of(net)
    got = make_eval_loss_step(net)(to_torch(batch))
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]),
                                   err_msg=k, **MODEL)
    assert all(torch.equal(v, before[k]) for k, v in stats_of(net).items())


# ------------------------------------------------------------------ remat ---
@pytest.mark.parametrize("remat,remat_encoder", [(True, False),
                                                 (True, True)])
def test_remat_matches_no_remat_and_jax(bn, remat, remat_encoder):
    """Batch norm: remat gives no remat's loss, gradients and running
    statistics (moved once, though a checkpointed trunk runs its forward
    twice), and the JAX step. The JAX package's remat_encoder cannot
    run a batch-norm model (nn.remat traces HGFilter's ``train`` flag,
    which BatchNorm needs as a Python bool): there the port is held to
    the JAX package's step without remat, which remat must equal."""
    state, batch, new, _, spread = bn

    def loss_grads(net):
        total = net(train=True, **to_torch(batch))[1]
        total.backward()
        return total.item(), {n: p.grad for n, p in net.named_parameters()}

    kw = dict(remat=remat, remat_encoder=remat_encoder)
    plain = port_net(state)
    l0, g0 = loss_grads(plain)
    net = port_net(state, **kw)
    l1, g1 = loss_grads(net)
    np.testing.assert_allclose(l1, l0, rtol=1e-6)
    for k, g in g0.items():
        np.testing.assert_allclose(g1[k].numpy(), g.numpy(), rtol=2e-5,
                                   atol=1e-6, err_msg=k)
    want_stats = stats_of(plain)
    for k, v in stats_of(net).items():
        assert torch.equal(v, want_stats[k]), k

    jm = FlaxSuRSNet(load_size=32, num_stack_lr=1, norm="batch", **kw)
    jstep = j_make_train_step(jm, optax.sgd(1.0), donate=False)
    if remat_encoder:
        with pytest.raises(jax.errors.TracerBoolConversionError):
            jstep(state, to_jax(batch))
    else:
        new, _ = jstep(state, to_jax(batch))
    before, after, _ = port_step(port_net(state, **kw), batch)
    assert_step_close(before, after, new, spread)


def test_remat_is_inert_without_grad(bn):
    state, batch, _, _, _ = bn
    a, b = port_net(state), port_net(state, remat=True, remat_encoder=True)
    with torch.no_grad():
        ya = a(train=True, **to_torch(batch))[0]
        yb = b(train=True, **to_torch(batch))[0]
    assert torch.equal(ya, yb)
    assert all(torch.equal(v, stats_of(a)[k])
               for k, v in stats_of(b).items())


# ------------------------------------------------------ serving batch norm ---
SERVE = dict(loadSize=32, num_stack_lr=1, resolution=32,
             octree_init_resolution=8, num_samples=4096,
             b_min=[-0.5, -0.5, -0.5], b_max=[0.5, 0.5, 0.5],
             mask_prune=True, dtype="float32", feature_dtype="float32",
             seed=2, norm="batch")


def subject():
    rng = np.random.default_rng(0)
    img = (rng.random((S, S, 3)) * 255).astype(np.uint8)
    yy, xx = np.mgrid[:S, :S]
    mask = (((xx - S / 2) / (S * 0.3)) ** 2 + ((yy - S / 2) / (S * 0.42)) ** 2
            < 1).astype(np.uint8) * 255
    return img, mask


def test_batch_norm_service_matches_jax():
    """The JAX service's {"params", "batch_stats"} (statistics perturbed
    from the init's) through params=: the same fields."""
    jcfg = JConfig(serve_octree_mode="mono", mc_backend="device",
                   mc_algorithm="cubes", **SERVE)
    model = j_net_from_config(jcfg)
    variables = seeded_variables(
        model, jnp.zeros((1, S, S, 3)), jnp.zeros((1, 2 * S, 2 * S, 3)),
        jnp.zeros((1, 3, 8)), jnp.zeros((1, 3, 8)), jnp.asarray(CALIB)[None],
        train=True)
    jsvc = JService(jcfg, params=variables, compilation_cache=False)
    tsvc = SuRSService(SuRSConfig(**SERVE), params=variables, device="cpu")
    img, mask = subject()
    want = jsvc.fields(img, mask)
    got = tsvc.fields(img, mask)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
    assert float(got[1].max()) > 0


# -------------------------------------------------------------- checkpoints ---
SPEC_TINY = dict(SERVE, residual=True)
NORM_WEIGHT = re.compile(r"\.bn(\d|_end\d)\.weight$")


def bn_reference_file(tmp_path, with_stats=True):
    """A reference-style state dict of a batch-norm model (README config,
    one lr stack): test_torch_checkpoint.py's spec and values, plus
    running_mean, running_var (positive) and num_batches_tracked beside
    every norm's weight."""
    from test_torch_checkpoint import load_spec, synthetic_sd
    sd = synthetic_sd(load_spec(one_stack=True))
    rng = np.random.default_rng(9)
    if with_stats:
        for k in [k for k in sd if NORM_WEIGHT.search(k)]:
            n = sd[k].shape[0]
            base = k[:-len("weight")]
            sd[base + "running_mean"] = torch.from_numpy(
                (rng.standard_normal(n) * 0.1).astype(np.float32))
            sd[base + "running_var"] = torch.from_numpy(
                rng.uniform(0.5, 2.0, n).astype(np.float32))
            sd[base + "num_batches_tracked"] = torch.tensor(7)
    path = str(tmp_path / "ref_bn")
    torch.save(sd, path)
    return path, sd


def test_batch_norm_reference_file_matches_jax_load_params(tmp_path):
    """load_netG on the file equals the JAX package's load_params import
    (``load_torch_checkpoint`` with a ``batch_stats`` tree) through the
    bridge exactly, every parameter and statistic from the file."""
    path, _ = bn_reference_file(tmp_path)
    jcfg = JConfig(load_netG_checkpoint_path=path, **SPEC_TINY)
    jm = j_net_from_config(jcfg)
    img = jax.ShapeDtypeStruct((1, S, S, 3), jnp.float32)
    img_hr = jax.ShapeDtypeStruct((1, 2 * S, 2 * S, 3), jnp.float32)
    pts = jax.ShapeDtypeStruct((1, 3, 8), jnp.float32)
    calib = jax.ShapeDtypeStruct((1, 4, 4), jnp.float32)
    shapes = jax.eval_shape(
        lambda k, a, b, p, q, c: jm.init(k, a, b, p, q, c, train=True),
        jax.random.PRNGKey(0), img, img_hr, pts, pts, calib)
    zeros = jax.tree_util.tree_map(lambda v: np.zeros(v.shape, v.dtype),
                                   shapes)
    j_params, j_stats, j_n = j_load_torch_checkpoint(
        path, zeros["params"], strict=False,
        batch_stats=zeros["batch_stats"])
    want = {**flax_to_state_dict(to_numpy(j_params)),
            **flax_to_state_dict(to_numpy(j_stats))}
    cfg = SuRSConfig(load_netG_checkpoint_path=path, **SPEC_TINY)
    net = surs_net_from_config(resolve_config(cfg, "cpu"), "cpu")
    n = load_netG(cfg, net)
    got = net.state_dict()
    assert n == j_n == len(got) == len(want)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert torch.equal(got[k], w), k


def test_batch_norm_reference_file_without_statistics_raises(tmp_path):
    path, sd = bn_reference_file(tmp_path, with_stats=False)
    cfg = SuRSConfig(load_netG_checkpoint_path=path, **SPEC_TINY)
    net = surs_net_from_config(resolve_config(cfg, "cpu"), "cpu")
    with pytest.raises(ValueError, match="untrained statistics"):
        import_torch_state_dict(sd, net)


def train_items(n_items=2):
    out = []
    for i in range(n_items):
        b = make_batch(seed=20 + i, rows=1)
        out.append({"name": f"s{i}", "img_LR": b["images_lr"][0],
                    "img_HR": b["images_hr"][0], "calib": CALIB,
                    "samples_LR": b["points_lr"][0],
                    "samples_HR": b["points_hr"][0],
                    "labels_disp": b["labels_lr"][0].T,
                    "labels_HR": b["labels_hr"][0].T})
    return out


def test_batch_norm_netG_round_trip(tmp_path):
    """train() writes the statistics into netG_latest; a strict load
    (the trainer's restore and the service's load_netG) gives them
    back, and they are not the init's."""
    cfg = SuRSConfig(**SERVE, num_sample_inout=N, batch_size=2,
                     freq_save_ply=0, num_epoch=1, no_gen_mesh=True,
                     checkpoints_path=str(tmp_path / "ck"),
                     results_path=str(tmp_path / "res"), name="bn")
    held = {}
    train(cfg, DataLoader(train_items(), batch_size=2, shuffle=False),
          device="cpu", on_step=lambda st, m: held.update(state=st))
    trained = held["state"].model.state_dict()
    path = CheckpointManager(cfg.checkpoints_path, cfg.name).path()
    svc = SuRSService(dataclasses.replace(cfg, load_netG_checkpoint_path=path),
                      device="cpu")
    fresh = surs_net_from_config(resolve_config(cfg, "cpu"), "cpu")
    for k, v in svc.model.state_dict().items():
        assert torch.equal(v, trained[k]), k
        if STATS.search(k):
            assert not torch.equal(v, fresh.state_dict()[k]), k


