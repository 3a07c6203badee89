"""The port's training data path against the JAX package's, on the CPU:
calibration and augmentation draws, render processing through PIL,
point sampling with winding-number labels, TrainDataset items on a tiny
dataset rendered by the port's render_dataset (with and without a sample
cache; the JAX package's renderer writes the same tree),
precompute_samples' .npz files, and one step of the port's train() from
its own dataset against the JAX train step.

Tolerances: everything the data path computes in numpy and PIL is equal
bit for bit (the same calls in the same order on the same draws). The
labels are equal: the sampled points lie off the surfaces by the jitter
(sigma 0.05 on meshes of radius 0.6-0.75), where the two winding
numbers (about 0 or 4 pi, 1e-4 apart at most, test_torch_containment.py)
are far from the cut at pi. The train step: losses to 1e-5 relative
as test_torch_train.py's plain step, the update per tensor to 1e-4 of
its norm (STEP_TOL)."""

import os
import runpy
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from surs_tpu.config import SuRSConfig as JaxConfig
from surs_tpu.data import calib as jax_calib
from surs_tpu.data import ext_transforms as jax_ext
from surs_tpu.data import image as jax_image
from surs_tpu.data import sampling as jax_sampling
from surs_tpu.data.datasets import TrainDataset as JaxTrainDataset
from surs_tpu.models import SuRSNet as FlaxSuRSNet
from surs_tpu.recon.mesh_io import save_obj_mesh
from surs_tpu.recon.tetra import marching_tetrahedra
from surs_tpu.render.dataset_gen import render_dataset as jax_render_dataset
from surs_tpu.train.loop import batch_host_arrays as jax_batch_host_arrays
from surs_tpu.train.step import create_train_state as jax_create_state
from surs_tpu.train.step import make_train_step as jax_make_train_step
from surs_tpu_torch.compat.flax_import import (flax_to_state_dict,
                                               load_flax_params)
from surs_tpu_torch.config import SuRSConfig, resolve_config
from surs_tpu_torch.data import TrainDataset
from surs_tpu_torch.data import calib, ext_transforms, image, sampling
from surs_tpu_torch.apps import precompute_samples
from surs_tpu_torch.models.surs_net import surs_net_from_config
from surs_tpu_torch.render import render_dataset
from surs_tpu_torch.train import loop
from surs_tpu_torch.train.checkpoint import CheckpointManager
from surs_tpu_torch.train.optim import make_optimizer
from surs_tpu_torch.train.step import create_train_state

torch.set_num_threads(1)
# one SGD(1.0) step's update, port against JAX, per tensor relative to
# the update's norm, beyond the parameter's own float32 rounding (ULP of
# its norm): the same float32 gradient summed in another order agrees to
# ~1e-5, but a pre-activation within float32 noise of 0 may take the
# other leaky-ReLU branch on one side, which scales one neuron's
# gradient from one point by 0.01 (5e-4 of mlp_hr.conv0's update on
# this batch). A wrong gradient path is off by O(1).
STEP_TOL = 2e-3
ULP = 2e-7
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAWS = [0, 180]
S = 32
AUG = dict(random_flip=True, random_scale=True, random_trans=True,
           aug_bri=0.3, aug_con=0.3, aug_sat=0.3, aug_hue=0.05,
           aug_blur=1.0)


def sphere_obj(path, radius_vox, R=16, scale=1.0 / 8):
    g = np.mgrid[:R, :R, :R].astype(np.float64) - (R - 1) / 2
    vol = (radius_vox - np.sqrt((g ** 2).sum(0))).astype(np.float32)
    verts, faces = marching_tetrahedra(vol, 0.0)
    save_obj_mesh(path, (np.asarray(verts) - (R - 1) / 2) * scale, faces)


def render_tiny_dataset(root, render=None):
    """Two sphere subjects (HR radius 6 and 5.5 voxels, LR 5 and 4.5),
    rendered at 32x32 from yaws 0 and 180 by the port's renderer on the
    CPU (or by ``render(obj_dir, root, **kw)``)."""
    obj_dir = os.path.join(root, "GEO", "OBJ")
    os.makedirs(obj_dir)
    for name, r in (("subj0", 6.0), ("subj1", 5.5)):
        sphere_obj(os.path.join(obj_dir, f"{name}_HR.obj"), r)
        sphere_obj(os.path.join(obj_dir, f"{name}_LR.obj"), r - 1.0)
    with open(os.path.join(root, "val.txt"), "w"):
        pass
    if render is None:
        render_dataset(obj_dir, root, load_size=S, yaw_step=180, patch=32,
                       device="cpu")
    else:
        render(obj_dir, root, load_size=S, yaw_step=180, patch=32)


@pytest.fixture(scope="module")
def dataroot(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_data"))
    render_tiny_dataset(root)
    return root


def test_fixture_renderers_write_the_same_tree(dataroot, tmp_path):
    """The fixture's dataset rendered by the JAX package: the same files,
    the same PARAM dicts; masks equal and the decoded JPEGs within 1 LSB
    on 99.9 % of the pixels (test_torch_render.py's tolerances)."""
    from test_torch_render import assert_same_dataset
    root = str(tmp_path / "jax")
    render_tiny_dataset(root, render=jax_render_dataset)
    for sub in ("RENDER", "MASK", "PARAM"):
        assert os.path.isdir(os.path.join(dataroot, sub, "subj1"))
        assert_same_dataset(os.path.join(dataroot, sub),
                            os.path.join(root, sub))


def configs(dataroot, **kw):
    base = dict(dataroot=dataroot, loadSize=S, num_sample_inout=32,
                sigma=0.05, b_min=[-1.0] * 3, b_max=[1.0] * 3, seed=7,
                **AUG)
    base.update(kw)
    return JaxConfig(**base), SuRSConfig(**base)


def assert_items_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert got[k] == w, k


# ------------------------------------------------------------ calibration --
@pytest.mark.parametrize("flip,scale,trans", [
    (True, True, True), (False, True, False), (True, False, True),
    (False, False, False)])
def test_calib_and_aug_draws_match_jax(flip, scale, trans):
    param = {"ortho_ratio": 0.4, "scale": 1.3,
             "center": np.array([0.1, 80.0, -0.2]),
             "R": np.linalg.qr(np.random.default_rng(5).standard_normal(
                 (3, 3)))[0]}
    for seed in range(6):
        want = jax_calib.sample_aug_params(np.random.default_rng(seed), 563,
                                           563, 512, flip, scale, trans)
        got = calib.sample_aug_params(np.random.default_rng(seed), 563, 563,
                                      512, flip, scale, trans)
        assert vars(got) == vars(want)
        for a, b in zip(calib.calib_from_param(param, 512, got),
                        jax_calib.calib_from_param(param, 512, want)):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------- images --
def pil_pair(seed=0, size=40):
    from PIL import Image
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    mask = ((((xx - size / 2) / (size * .3)) ** 2
             + ((yy - size / 2) / (size * .45)) ** 2) < 1) * 255
    rgb = (rng.random((size, size, 3)) * 255).astype(np.uint8)
    return Image.fromarray(rgb), Image.fromarray(mask.astype(np.uint8))


@pytest.mark.parametrize("is_train,hue", [(True, 0.05), (True, 0.0),
                                          (False, 0.0)])
def test_process_render_matches_jax(is_train, hue):
    """Every augmentation on: pad, flip, scale, translate + crop,
    ColorJitter (brightness, contrast, saturation, hue), blur, the LR
    pair; the same draws, the same pixels."""
    render, mask = pil_pair()
    aug = calib.AugParams(flip=True, scale=0.93, dx=2, dy=-1)
    kw = dict(aug_bri=0.4, aug_con=0.4, aug_sat=0.4, aug_hue=hue,
              aug_blur=1.5)
    want = jax_image.process_render(render, mask, S, is_train, aug,
                                    np.random.default_rng(3), **kw)
    got = image.process_render(render, mask, S, is_train, aug,
                               np.random.default_rng(3), **kw)
    for a, b in zip(got, want):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    side = S if is_train else 40          # the test phase keeps the size
    assert got[0].shape == (side, side, 3)
    assert got[3].shape == (side // 2, side // 2, 1)


def test_ext_transforms_match_jax():
    render, _ = pil_pair(1)
    for fn, arg in ((("random_vertical_flip"), render),
                    (("random_gaussian_blur"), render)):
        a = getattr(ext_transforms, fn)(arg, np.random.default_rng(2))
        b = getattr(jax_ext, fn)(arg, np.random.default_rng(2))
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    img = np.asarray(render, np.float32) / 255.0
    np.testing.assert_array_equal(
        ext_transforms.pca_lighting(img, np.random.default_rng(4), 0.2),
        jax_ext.pca_lighting(img, np.random.default_rng(4), 0.2))


_NO_PIL = r"""
import sys
sys.modules["PIL"] = None
import surs_tpu_torch.data, surs_tpu_torch.apps.train_surs
import surs_tpu_torch.apps.precompute_samples, surs_tpu_torch.train.loop
print("imported")
"""


def test_without_pil_the_image_path_names_pil(monkeypatch):
    """The data package and the training entry points import without
    PIL; the functions that need it raise an error that names it."""
    run = subprocess.run([sys.executable, "-c", _NO_PIL], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert run.returncode == 0 and "imported" in run.stdout, run.stderr
    render, mask = pil_pair()
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="PIL"):
        image.process_render(render, mask, S, False, None)
    with pytest.raises(RuntimeError, match="PIL"):
        image.load_render_mask_pil("a.jpg", "a.png")
    with pytest.raises(RuntimeError, match="PIL"):
        ext_transforms.random_gaussian_blur(render,
                                            np.random.default_rng(0))


# --------------------------------------------------------------- sampling --
def cube_mesh(half):
    v = np.array([[x, y, z] for x in (-half, half) for y in (-half, half)
                  for z in (-half, half)], np.float32)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    f = [t for a, b, c, d in quads for t in ((a, b, c), (a, c, d))]
    return v, np.array(f, np.int64)


@pytest.mark.parametrize("n", [200, 37])
def test_sample_points_and_labels_match_jax(n):
    hr, lr = cube_mesh(0.5), cube_mesh(0.4)
    box = (np.array([-1.0] * 3), np.array([1.0] * 3))
    want = jax_sampling.sample_points_and_labels(
        jax_sampling.MeshData(*hr), jax_sampling.MeshData(*lr), n, 0.1,
        *box, np.random.default_rng(11))
    got = sampling.sample_points_and_labels(
        sampling.MeshData(*hr), sampling.MeshData(*lr), n, 0.1, *box,
        np.random.default_rng(11), device="cpu")
    assert_items_equal(got, want)
    # N/2 inside + N/2 outside: an odd N loses one point where more than
    # N/2 are inside, as in the JAX package
    assert got["samples_HR"].shape[1] in (n - n % 2, n)
    # the labels are the truth on a cube
    np.testing.assert_array_equal(
        got["labels_HR"][0], (np.abs(got["samples_HR"].T) < 0.5).all(1))


# ---------------------------------------------------------------- dataset --
def jax_precompute(argv):
    old = sys.argv
    sys.argv = ["precompute_samples.py"] + argv
    try:
        runpy.run_path(os.path.join(ROOT, "apps", "precompute_samples.py"),
                       run_name="__main__")
    finally:
        sys.argv = old


@pytest.fixture(scope="module")
def sample_caches(dataroot, tmp_path_factory):
    """The same draws cached by the JAX app and by the port's."""
    out = {}
    for who in ("jax", "port"):
        d = str(tmp_path_factory.mktemp(f"cache_{who}"))
        argv = ["--dataroot", dataroot, "--out", d, "--num_sample_inout",
                "32", "--sigma", "0.05", "--draws", "3", "--b_min", "-1",
                "-1", "-1", "--b_max", "1", "1", "1", "--seed", "5"]
        if who == "jax":
            jax_precompute(argv)
        else:
            assert precompute_samples.main(argv + ["--device", "cpu"]) == 6
        out[who] = d
    return out


def test_precompute_samples_matches_jax(sample_caches):
    files = sorted(os.listdir(sample_caches["jax"]))
    assert files == [f"subj{s}_{d:03d}.npz" for s in (0, 1)
                     for d in range(3)]
    assert sorted(os.listdir(sample_caches["port"])) == files
    for f in files:
        with np.load(os.path.join(sample_caches["jax"], f)) as a, \
                np.load(os.path.join(sample_caches["port"], f)) as b:
            assert sorted(a.files) == sorted(b.files) == [
                "labels_HR", "labels_disp", "samples_HR", "samples_LR"]
            for k in a.files:
                np.testing.assert_array_equal(b[k], a[k], err_msg=f + k)


@pytest.mark.parametrize("phase,cached", [("test", False), ("train", False),
                                          ("test", True), ("train", True)])
def test_train_dataset_items_match_jax(dataroot, sample_caches, phase,
                                       cached):
    jcfg, pcfg = configs(dataroot)
    cache = sample_caches["port"] if cached else None
    want_ds = JaxTrainDataset(jcfg, phase, yaw_list=YAWS,
                              sample_cache_dir=cache)
    got_ds = TrainDataset(pcfg, phase, yaw_list=YAWS, sample_cache_dir=cache,
                          contains_device="cpu")
    assert len(got_ds) == len(want_ds) == 4
    for i in range(4):
        rng_seed = 100 + i
        want = want_ds.get_item(i, np.random.default_rng(rng_seed))
        got = got_ds.get_item(i, np.random.default_rng(rng_seed))
        assert_items_equal(got, want)
    assert got["img_LR"].shape == (S // 2, S // 2, 3)
    assert got["samples_HR"].shape == (3, 32)


def test_train_dataset_color_renders_raise(dataroot, tmp_path):
    """Color samples from UV renders are ported (ROADMAP.md A11;
    tests/test_torch_uv.py holds the items to the JAX package's): without
    a UV_RENDER folder an item has no color samples; with one whose files
    are missing, the item raises, as the JAX package's does."""
    jcfg, pcfg = configs(dataroot, num_sample_color=8)
    ds = TrainDataset(pcfg, yaw_list=YAWS, contains_device="cpu")
    assert "rgbs" not in ds.get_item(0, np.random.default_rng(0))
    uv = os.path.join(dataroot, "UV_RENDER")
    os.makedirs(uv)
    try:
        for d in (TrainDataset(pcfg, yaw_list=YAWS, contains_device="cpu"),
                  JaxTrainDataset(jcfg, yaw_list=YAWS)):
            assert d.has_uv_renders()
            with pytest.raises(FileNotFoundError):
                d.get_item(0, np.random.default_rng(0))
    finally:
        os.rmdir(uv)


# ---------------------------------------------------------- whole slice --
@pytest.fixture(scope="module")
def jax_step():
    """The JAX side of the step test, built once: a Flax init (the
    model, SGD(1.0), the state and its weights) and the jitted step."""
    fmodel = FlaxSuRSNet(load_size=S, num_stack_lr=2)
    opt = optax.sgd(1.0)
    dummy = {"images_lr": jnp.zeros((2, S // 2, S // 2, 3)),
             "images_hr": jnp.zeros((2, S, S, 3)),
             "points_lr": jnp.zeros((2, 3, 32)),
             "points_hr": jnp.zeros((2, 3, 32)),
             "calibs": jnp.tile(jnp.eye(4), (2, 1, 1)),
             "labels_lr": jnp.zeros((2, 32, 1)),
             "labels_hr": jnp.zeros((2, 32, 1))}
    jstate = jax_create_state(fmodel, opt, jax.random.PRNGKey(0), dummy)
    params0 = jax.tree_util.tree_map(np.asarray, jstate.params)
    return jstate, params0, jax_make_train_step(fmodel, opt, donate=False)


def seed_item_draws(monkeypatch, seed):
    """Give the dataset's training items ``default_rng(seed * 100 +
    call)`` instead of the OS-seeded draw, so a run trains on a known
    batch; returns the call counter (reset it to replay the batch)."""
    calls = [0]
    get_item = TrainDataset.get_item

    def draw(self, index, rng=None):
        if rng is None and self.is_train:
            rng = np.random.default_rng(seed * 100 + calls[0])
            calls[0] += 1
        return get_item(self, index, rng)

    monkeypatch.setattr(TrainDataset, "get_item", draw)
    return calls


def update_gap(new_a, base_a, new_b, base_b, ulp_of):
    """Norm of the gap between two updates ``new - base`` beyond float32
    rounding (ULP of ``ulp_of``'s norm), relative to the first update's
    norm."""
    step = float((new_a - base_a).norm())
    err = float(((new_a - base_a) - (new_b - base_b)).norm()) \
        - ULP * float(ulp_of.norm())
    return max(err, 0.0) / step if step else max(err, 0.0)


@pytest.mark.parametrize("seed", [1, 3, 5])
def test_train_step_from_the_dataset_matches_jax(dataroot, tmp_path,
                                                 monkeypatch, jax_step,
                                                 seed):
    """One step of the port's train() on its own dataset's first batch
    (SGD(1.0) from weights written by a Flax init) against the JAX
    train step on the same batch. The batch is drawn from ``seed``. The
    update of each tensor is held to the JAX update within
    max(STEP_TOL, 2 x spread), where ``spread`` is the largest gap
    between two port steps on the same batch, one from the weights and
    one from the weights scaled by (1 + 1e-7 N(0, 1)): on a batch with a
    pre-activation at a leaky-ReLU kink the gradient jumps within
    float32 noise, and the port is held to its own jump there."""
    jstate, params0, jstep = jax_step
    _, pcfg = configs(dataroot)
    cfg = SuRSConfig(**{**vars(pcfg), "num_stack_lr": 2, "batch_size": 2,
                        "optimizer": "SGD", "momentum": 0.0,
                        "learning_rate": 1.0, "no_gen_mesh": True,
                        "freq_save_ply": 0, "serial_batches": True,
                        "name": "slice",
                        "checkpoints_path": str(tmp_path / "ckpt"),
                        "results_path": str(tmp_path / "res")})
    rcfg = resolve_config(cfg, "cpu")
    calls = seed_item_draws(monkeypatch, seed)
    seen = {}
    host_arrays = loop.batch_host_arrays

    def capture(raw, quantize_images=False):
        seen["raw"] = raw
        return host_arrays(raw, quantize_images)

    monkeypatch.setattr(loop, "batch_host_arrays", capture)

    def port_step(params, tag):
        """The port's train() for one step from ``params`` (written as
        its initial checkpoint); returns (state dict, metrics, raw
        batch)."""
        net = load_flax_params(surs_net_from_config(rcfg, "cpu"), params)
        CheckpointManager(str(tmp_path / tag), "w").save(
            create_train_state(net, make_optimizer(rcfg, net.parameters())),
            0)
        calls[0] = 0
        run = SuRSConfig(**{**vars(cfg), "load_netG_checkpoint_path":
                            str(tmp_path / tag / "w"),
                            "checkpoints_path": str(tmp_path / tag / "ck")})
        out = loop.train(run, max_iters=1, device="cpu", yaw_list=YAWS,
                         on_step=lambda st, m: seen.update(state=st, m=m))
        assert out["iters"] == 1 and seen["state"].step == 1
        return ({k: v.clone() for k, v in
                 seen["state"].model.state_dict().items()},
                seen["m"], seen["raw"])

    got_sd, m, raw = port_step(params0, "init")
    assert raw["name"] == ["subj0", "subj1"] and raw["yid"] == [0, 0]
    host = jax_batch_host_arrays(raw, quantize_images=True)
    for k, v in loop.batch_host_arrays(raw, True).items():
        np.testing.assert_array_equal(v, host[k], err_msg=k)
    new, want_m = jstep(jstate, {k: jnp.asarray(v) for k, v in host.items()})
    for k in ("mlp1", "mlp2", "sr", "disp", "total"):
        np.testing.assert_allclose(m[k].item(), float(want_m[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    want_sd = flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                        new.params))
    p0 = flax_to_state_dict(params0)
    assert sorted(want_sd) == sorted(got_sd)

    # the same batch from the weights scaled by (1 + 1e-7 N(0, 1))
    noise = np.random.default_rng(0)
    scaled = jax.tree_util.tree_map(
        lambda w: (w * (1 + 1e-7 * noise.standard_normal(w.shape))
                   ).astype(w.dtype), params0)
    got_p, _, raw_p = port_step(scaled, "scaled")
    for k, v in raw_p.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(v, raw[k], err_msg=k)
    p0_p = flax_to_state_dict(scaled)
    spread = max(update_gap(got_sd[k], p0[k], got_p[k], p0_p[k], got_sd[k])
                 for k in want_sd)
    # the update (the gradient, under SGD(1.0)) per tensor, relative to
    # its norm
    worst = max(update_gap(want_sd[k], p0[k], got_sd[k], p0[k], want_sd[k])
                for k in want_sd)
    assert worst <= max(STEP_TOL, 2 * spread), (worst, spread)


@pytest.mark.parametrize("slope", [0.2, 0.01])
def test_leaky_relu_gradient_matches_flax_at_zero(slope):
    """Masked images give exact zeros before the SR branch's activations:
    there the gradient is flax's (1), not F.leaky_relu's (slope)."""
    from flax import linen as fnn
    from surs_tpu_torch.models.layers import leaky_relu
    x = np.array([-1.5, -0.0, 0.0, 2.0, -1e-30], np.float32)
    want = jax.grad(lambda v: fnn.leaky_relu(v, slope).sum())(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    y = leaky_relu(t, slope)
    y.sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.asarray(fnn.leaky_relu(x, slope)))
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))
