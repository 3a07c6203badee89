"""The JAX package's orbax train states read into the port
(surs_tpu_torch/compat/orbax_import.py): directories written on this
host by the JAX package's own ``CheckpointManager`` (orbax
``StandardCheckpointer``), read back by the port with tensorstore alone.

Tolerances: the weights, batch statistics, moments, learning rate and
step are read bit for bit. A served field from the directory equals the
JAX service's from the same directory within 1e-5 (float32, tests/
test_torch_checkpoint.py's reference-file tolerance is the same order).
One training step from the restored state agrees with one JAX step from
it to rtol 2e-4, atol 2e-6, tests/test_torch_train.py's tolerance for a
step (the gradient sums over the batch in another order).
"""

import functools
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree
import numpy as np
import pytest
import torch

from surs_tpu.config import SuRSConfig as JConfig
from surs_tpu.models import surs_net_from_config as j_net
from surs_tpu.serve import SuRSService as JService
from surs_tpu.train.checkpoint import CheckpointManager as JCheckpoints
from surs_tpu.train.optim import make_optimizer as j_optimizer
from surs_tpu.train.step import TrainState, denormalize_images
from surs_tpu_torch.compat.flax_import import flax_to_state_dict
from surs_tpu_torch.compat.orbax_import import read_tree, resolve_tag
from surs_tpu_torch.config import SuRSConfig
from surs_tpu_torch.models.surs_net import surs_net_from_config
from surs_tpu_torch.serve import SuRSService
from surs_tpu_torch.train.checkpoint import CheckpointManager
from surs_tpu_torch.train.loop import batch_host_arrays, train
from surs_tpu_torch.train.optim import make_optimizer
from surs_tpu_torch.train.step import create_train_state

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, B, N = 16, 2, 32
TINY = dict(loadSize=32, num_stack_lr=1, resolution=32,
            octree_init_resolution=8, num_samples=4096,
            b_min=[-0.5] * 3, b_max=[0.5] * 3, mask_prune=True,
            dtype="float32", feature_dtype="float32", seed=2)
FIELD_TOL = 1e-5
STEP_TOL = dict(rtol=2e-4, atol=2e-6)
SAVED_STEP = 5
SAVED_LR = np.float32(7e-4)         # not the config's: read from the file


@functools.lru_cache(maxsize=None)
def init_shapes(norm):
    model = j_net(JConfig(norm=norm, **TINY))
    sample = {"images_lr": jnp.zeros((1, S, S, 3)),
              "images_hr": jnp.zeros((1, 2 * S, 2 * S, 3)),
              "points_lr": jnp.zeros((1, 3, 8)),
              "points_hr": jnp.zeros((1, 3, 8)),
              "calibs": jnp.zeros((1, 4, 4))}
    return model, jax.eval_shape(
        lambda k: model.init(k, **sample, train=True), jax.random.PRNGKey(0))


def leaf_name(path):
    k = path[-1]
    return getattr(k, "name", getattr(k, "key", None))


def seeded(tree, seed):
    """Arrays of ``tree``'s shapes from a numpy seed: kernels and biases
    N(0, 0.05), norm scales 1 + N(0, 0.05), statistics means N(0, 0.1)
    and variances in [0.5, 2]; optimizer moments N(0, 1e-3), second
    moments |N(0, 1e-3)|, counts 3, the learning rate SAVED_LR."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = leaf_name(path)
        fields = {getattr(k, "name", None) for k in path}
        if name == "count":
            w = np.full(s.shape, 3)
        elif name == "learning_rate":
            w = np.full(s.shape, SAVED_LR)
        elif name == "var":
            w = rng.uniform(0.5, 2.0, s.shape)
        else:
            w = rng.standard_normal(s.shape)
            if fields & {"nu", "nu_max"}:
                w = np.abs(w) * 1e-3
            elif fields & {"mu", "trace"}:
                w = w * 1e-3
            else:
                w = w * (0.1 if name == "mean" else 0.05) + (name == "scale")
        return np.asarray(w, s.dtype)
    return jax.tree_util.tree_map_with_path(draw, tree)


def jax_config(**kw):
    return JConfig(**{**TINY, "learning_rate": 1e-3, **kw})


def save_jax_state(root, norm="group", optimizer="ADAM", weight_decay=0.0,
                   seed=0, latest=True):
    """A JAX TrainState with seeded weights and optimizer state, saved by
    the JAX package's CheckpointManager as ``root/exp/netG_epoch_2`` and
    (``latest``) ``netG_latest``; returns (model, state, optax
    optimizer). A state is about 100 MB on disk."""
    model, shapes = init_shapes(norm)
    params = seeded(shapes["params"], seed)
    opt = j_optimizer(jax_config(optimizer=optimizer,
                                 weight_decay=weight_decay))
    opt_state = seeded(jax.eval_shape(opt.init, params), seed + 1)
    stats = seeded(shapes["batch_stats"], seed + 2) \
        if "batch_stats" in shapes else None
    state = TrainState(step=np.int32(SAVED_STEP), params=params,
                       opt_state=opt_state, batch_stats=stats)
    JCheckpoints(str(root), "exp").save(
        jax.tree_util.tree_map(jnp.asarray, state), epoch=2, latest=latest)
    return model, state, opt


def as_state_dict(state):
    out = flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                    state.params))
    if state.batch_stats is not None:
        out.update(flax_to_state_dict(jax.tree_util.tree_map(
            np.asarray, state.batch_stats)))
    return out


def subject():
    rng = np.random.default_rng(0)
    img = (rng.random((S, S, 3)) * 255).astype(np.uint8)
    yy, xx = np.mgrid[:S, :S]
    mask = (((xx - S / 2) / (S * 0.3)) ** 2 + ((yy - S / 2) / (S * 0.42)) ** 2
            < 1).astype(np.uint8) * 255
    return img, mask


@pytest.fixture(scope="module")
def saved_dirs(tmp_path_factory):
    """{norm: (experiment directory, state)}: a group-norm state with
    both tags, a batch-norm one as netG_epoch_2."""
    out = {}
    for norm in ("group", "batch"):
        root = tmp_path_factory.mktemp(f"jax_{norm}")
        _, state, _ = save_jax_state(root, norm=norm,
                                     latest=norm == "group")
        out[norm] = (root / "exp", state)
    yield out
    for root, _ in out.values():
        shutil.rmtree(root.parent)


@pytest.fixture
def group_dir(saved_dirs):
    return saved_dirs["group"]


# ----------------------------------------------------------- the reader --
@pytest.mark.parametrize("norm", ["group", "batch"])
def test_tree_equals_the_saved_state(saved_dirs, norm):
    """Every array leaf of the train state, bit for bit; the group-norm
    state's batch_stats (None) and optax's empty states are absent."""
    root, state = saved_dirs[norm]
    tree = read_tree(str(root / "netG_epoch_2"))
    want = jax.tree_util.tree_leaves_with_path(state)
    assert sorted(tree) == (["batch_stats"] if norm == "batch" else []) \
        + ["opt_state", "params", "step"]
    for path, leaf in want:
        node = tree
        for k in path:
            key = getattr(k, "name", getattr(k, "key", getattr(k, "idx",
                                                               None)))
            node = node[str(key)]
        np.testing.assert_array_equal(node, np.asarray(leaf),
                                      err_msg=str(path))


@pytest.mark.parametrize("tag", ["netG_latest", "netG_epoch_2"])
def test_service_from_the_directory_matches_jax(group_dir, tag):
    """The port's service loads the directory through load_netG: its
    state dict is the JAX params through the bridge, bit for bit, and
    its field equals the JAX service's from the same directory."""
    root, state = group_dir
    path = str(root / tag)
    img, mask = subject()
    svc = SuRSService(SuRSConfig(load_netG_checkpoint_path=path, **TINY),
                      device="cpu")
    want = as_state_dict(state)
    got = svc.model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    if tag != "netG_latest":
        return
    jsvc = JService(JConfig(load_netG_checkpoint_path=path,
                            serve_octree_mode="mono", mc_backend="device",
                            mc_algorithm="cubes", **TINY),
                    compilation_cache=False)
    for g, w in zip(svc.fields(img, mask), jsvc.fields(img, mask)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=0, atol=FIELD_TOL)


def test_batch_norm_directory_serves_its_statistics(saved_dirs):
    """A batch-norm train state: params and running statistics load
    strictly; the service's field equals one given the same variables
    through params=."""
    root, state = saved_dirs["batch"]
    path = str(root / "netG_epoch_2")
    cfg = SuRSConfig(norm="batch", **TINY)
    svc = SuRSService(SuRSConfig(load_netG_checkpoint_path=path,
                                 norm="batch", **TINY), device="cpu")
    for k, v in as_state_dict(state).items():
        torch.testing.assert_close(svc.model.state_dict()[k], v, rtol=0,
                                   atol=0)
    variables = jax.tree_util.tree_map(
        np.asarray, {"params": state.params,
                     "batch_stats": state.batch_stats})
    ref = SuRSService(cfg, params=variables, device="cpu")
    img, mask = subject()
    for g, w in zip(svc.fields(img, mask), ref.fields(img, mask)):
        assert torch.equal(torch.as_tensor(g), torch.as_tensor(w))
    assert any(k.endswith("running_var") for k in svc.model.state_dict())


def test_resolve_tag_follows_the_jax_loader(tmp_path):
    assert resolve_tag(str(tmp_path / "netG_epoch_7")) == str(
        tmp_path / "netG_epoch_7")
    assert resolve_tag(str(tmp_path / "anything/")) == str(
        tmp_path / "netG_latest")


def test_foreign_directory_names_what_is_missing(tmp_path):
    d = tmp_path / "netG_latest"
    d.mkdir()
    (d / "_METADATA").write_text('{"format": "something else"}')
    with pytest.raises(ValueError, match="tree_metadata"):
        read_tree(str(d))


def test_reader_imports_neither_jax_nor_orbax(group_dir):
    root, _ = group_dir
    code = ("import sys; "
            "from surs_tpu_torch.compat.orbax_import import read_tree; "
            f"t = read_tree({str(root / 'netG_latest')!r}); "
            "assert sorted(t) == ['opt_state', 'params', 'step'], sorted(t); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'orbax', 'flax', 'surs_tpu')]; "
            "assert not bad, bad; print('clean')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


# ---------------------------------------------------------- the trainer --
def raw_batch(seed=3):
    """One collated batch in the training dataset's format."""
    rng = np.random.default_rng(seed)
    return {
        "img_LR": rng.uniform(-1, 1, (B, S, S, 3)).astype(np.float32),
        "img_HR": rng.uniform(-1, 1, (B, 2 * S, 2 * S, 3)).astype(
            np.float32),
        "calib": np.tile(np.diag([2.0, -2.0, 2.0, 1.0]).astype(np.float32),
                         (B, 1, 1)),
        "samples_LR": ((rng.random((B, 3, N)) - 0.5) * 1.4).astype(
            np.float32),
        "samples_HR": ((rng.random((B, 3, N)) - 0.5) * 1.4).astype(
            np.float32),
        "labels_disp": rng.random((B, 1, N)).astype(np.float32),
        "labels_HR": (rng.random((B, 1, N)) > 0.5).astype(np.float32),
    }


def flat_state(node, params):
    """An optax state over ``params`` with every params-shaped subtree
    raveled into one vector: the same elementwise rules, one leaf to
    trace instead of hundreds."""
    if jax.tree_util.tree_structure(node) == \
            jax.tree_util.tree_structure(params) and node is not None \
            and jax.tree_util.tree_leaves(node):
        return ravel_pytree(node)[0]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(flat_state(v, params) for v in node))
    if isinstance(node, (tuple, list)):
        return type(node)(flat_state(v, params) for v in node)
    if isinstance(node, dict):
        return {k: flat_state(v, params) for k, v in node.items()}
    return node


@pytest.fixture(scope="module")
def jax_grads():
    """The JAX loss's gradient at the seeded group-norm params on
    raw_batch (the uint8 wire format the trainers ship, as both loops
    quantize), and those params."""
    model, shapes = init_shapes("group")
    params = seeded(shapes["params"], 0)
    batch = denormalize_images({k: jnp.asarray(v) for k, v in
                                batch_host_arrays(raw_batch(), True).items()})

    def loss(p):
        return model.apply({"params": p}, train=True, **batch)[1]
    return params, jax.jit(jax.grad(loss))(params)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("kind", ["SGD", "ADAM", "RMSprop", "AMSgrad"])
def test_trainer_resumes_a_jax_state_and_steps_as_jax(tmp_path, jax_grads,
                                                      kind, weight_decay):
    """train() with load_netG_checkpoint_path at the JAX run's
    directory: the step count, the learning rate and the moments come
    from the file, and the first step moves the weights as the JAX
    package's step (gradient, optax update, apply) from the same state."""
    params, grads = jax_grads
    _, state, opt = save_jax_state(tmp_path, optimizer=kind,
                                   weight_decay=weight_decay, latest=False)
    os.rename(tmp_path / "exp" / "netG_epoch_2",
              tmp_path / "exp" / "netG_latest")
    flat, unravel = ravel_pytree(params)
    updates, _ = jax.jit(opt.update)(ravel_pytree(grads)[0],
                                     flat_state(state.opt_state, params),
                                     flat)
    # optax.apply_updates' float32 p + u, in numpy
    want = flax_to_state_dict(jax.tree_util.tree_map(
        lambda p, u: p + np.asarray(u), params, unravel(updates)))

    cfg = SuRSConfig(loadSize=32, num_stack_lr=1, num_sample_inout=N,
                     batch_size=B, optimizer=kind,
                     weight_decay=weight_decay, learning_rate=1e-3,
                     freq_plot=1, freq_save=50, freq_save_ply=0,
                     num_epoch=1, no_gen_mesh=True,
                     checkpoints_path=str(tmp_path / "port"),
                     results_path=str(tmp_path / "res"), name="t",
                     load_netG_checkpoint_path=str(tmp_path / "exp"))
    seen = {}

    def on_step(st, _):
        seen["step"] = st.step
        seen["lr"] = st.optimizer.param_groups[0]["lr"]
        seen["params"] = {k: v.detach().clone()
                          for k, v in st.model.state_dict().items()}
    train(cfg, [raw_batch()], max_iters=1, device="cpu", on_step=on_step)
    shutil.rmtree(tmp_path)             # 0.3 GB of checkpoints
    assert seen["step"] == SAVED_STEP + 1
    assert seen["lr"] == float(SAVED_LR)
    assert sorted(seen["params"]) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(seen["params"][k].numpy(), v.numpy(),
                                   err_msg=k, **STEP_TOL)


def test_continue_train_resumes_from_a_jax_epoch(tmp_path):
    """continue_train == 0 with resume_epoch 2 reads the JAX run's
    netG_epoch_2 directory in the port's own checkpoints folder; the
    port's next save replaces the directory with its file."""
    save_jax_state(tmp_path, latest=False)
    cfg = SuRSConfig(loadSize=32, num_stack_lr=1, num_sample_inout=N,
                     batch_size=B, freq_plot=1, freq_save=50,
                     freq_save_ply=0, num_epoch=3, no_gen_mesh=True,
                     dtype="float32", feature_dtype="float32",
                     checkpoints_path=str(tmp_path), name="exp",
                     results_path=str(tmp_path / "res"), continue_train=0,
                     resume_epoch=2)
    model = surs_net_from_config(cfg, "cpu")
    restored = CheckpointManager(str(tmp_path), "exp").restore(
        create_train_state(model, make_optimizer(cfg, model.parameters())),
        2)
    assert restored.step == SAVED_STEP
    seen = []
    train(cfg, [raw_batch()], max_iters=1, device="cpu",
          on_step=lambda st, _: seen.append(st.step))
    assert seen == [SAVED_STEP + 1]
    saved = [(tmp_path / "exp" / tag).is_file()
             for tag in ("netG_epoch_2", "netG_latest")]
    shutil.rmtree(tmp_path)
    assert saved == [True, True]
