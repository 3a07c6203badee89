"""The port's eval entry point (surs_tpu_torch/apps/eval_surs.py) and
what it stands on, against the JAX package on the CPU:

* ``EvalDataset`` and ``load_render_mask`` (data/datasets.py): the same
  items exactly, in directory and single-image mode, with PIL and, for
  PNG, without it;
* ``parse_config`` / ``print_config``: the same dump;
* ``main([..., "--device", "cpu"])`` with PIL hidden writes the OBJ
  pairs of the JAX ``apps/eval_surs.py`` from the same PNGs and the same
  reference checkpoint, compared as tests/test_torch_pipeline.py
  compares (same face counts, the same vertex sets);
* ``Reconstructor.reconstruct(transform=, level=)`` against the JAX
  ``Reconstructor.reconstruct``, and the functional ``reconstruction``
  and ``gen_mesh``;
* ``reconstruct_many(writer_thread=True)`` and the staged
  ``extract_pair`` give what the sequential path gives, byte for byte.
"""

import json
import os
import re
import runpy
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from scipy.spatial import cKDTree

from surs_tpu.config import SuRSConfig as JConfig
from surs_tpu.config import parse_config as j_parse_config
from surs_tpu.config import print_config as j_print_config
from surs_tpu.data import EvalDataset as JEvalDataset
from surs_tpu.recon.mesh_io import load_obj as j_load_obj
from surs_tpu.serve import SuRSService as JService
from surs_tpu.serve import normalize_image as j_normalize_image
from surs_tpu_torch.apps.eval_surs import main
from surs_tpu_torch.config import SuRSConfig, parse_config, print_config
from surs_tpu_torch.data.datasets import EvalDataset
from surs_tpu_torch.recon.marching import marching_cubes
from surs_tpu_torch.recon.mesh_io import load_obj
from surs_tpu_torch.recon.pipeline import (Reconstructor, eval_calibration,
                                           gen_mesh, reconstruction)
from surs_tpu_torch.serve import SuRSService, normalize_image

torch.set_num_threads(1)
S = 16
APP = os.path.join(os.path.dirname(__file__), "..", "apps", "eval_surs.py")
SPEC_PATH = os.path.join(os.path.dirname(__file__), "fixtures",
                         "ref_netG_state_spec.json")
# tests/test_torch_pipeline.py's tiny service (random weights, seed 2)
COMMON = dict(loadSize=32, num_stack_lr=1, resolution=32,
              octree_init_resolution=8, num_samples=4096,
              b_min=[-0.5, -0.5, -0.5], b_max=[0.5, 0.5, 0.5],
              mask_prune=True, dtype="float32", feature_dtype="float32",
              seed=2)
# the same flags for both CLIs: the README config's residual SR at tiny
# widths, and the JAX package's device marching cubes (the port's only
# extractor) in float32
CLI_FLAGS = ["--loadSize", "32", "--num_stack_lr", "1", "--residual",
             "--resolution", "32", "--octree_init_resolution", "8",
             "--num_samples", "4096", "--seed", "2",
             "--b_min", "-0.5", "-0.5", "-0.5", "--b_max", "0.5", "0.5", "0.5",
             "--octree_mode", "mono", "--mc_backend", "device",
             "--mc_algorithm", "cubes", "--dtype", "float32",
             "--feature_dtype", "float32"]


def subject(seed=0, shift=0):
    rng = np.random.default_rng(seed)
    img = (rng.random((S, S, 3)) * 255).astype(np.uint8)
    yy, xx = np.mgrid[:S, :S]
    mask = (((xx - S / 2 - shift) / (S * 0.3)) ** 2
            + ((yy - S / 2) / (S * 0.42)) ** 2 < 1).astype(np.uint8) * 255
    return img, mask


def eval_root(tmp_path, names=("b_subj", "a_subj"), ext="png"):
    root = tmp_path / "data"
    (root / "image_final").mkdir(parents=True)
    (root / "mask_final").mkdir(parents=True)
    for i, name in enumerate(names):
        img, mask = subject(seed=i, shift=i)
        Image.fromarray(img).save(str(root / "image_final" / f"{name}.{ext}"))
        Image.fromarray(mask).save(str(root / "mask_final" / f"{name}.png"))
    return root


def assert_items_equal(got, want):
    assert sorted(got) == sorted(want)
    assert got["name"] == want["name"]
    for k in ("img_LR", "mask_LR", "calib", "b_min", "b_max"):
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k])


# ------------------------------------------------------------ EvalDataset ---
@pytest.mark.parametrize("hide_pil", [False, True])
def test_eval_dataset_directory_mode_matches_jax(tmp_path, monkeypatch,
                                                 hide_pil):
    root = eval_root(tmp_path)
    jds = JEvalDataset(JConfig(dataroot=str(root), loadSize=32))
    want = [jds[i] for i in range(len(jds))]      # decoded with PIL
    if hide_pil:
        monkeypatch.setitem(sys.modules, "PIL", None)
    got = EvalDataset(SuRSConfig(dataroot=str(root), loadSize=32))
    assert len(got) == len(want) == 2
    for i in range(2):
        assert_items_equal(got[i], want[i])
    assert got[0]["name"] == "a_subj"
    assert got[0]["img_LR"].shape == (1, S, S, 3)


@pytest.mark.parametrize("with_mask_path", [False, True])
def test_eval_dataset_single_image_matches_jax(tmp_path, monkeypatch,
                                               with_mask_path):
    root = eval_root(tmp_path)
    img_path = str(root / "image_final" / "b_subj.png")
    mask_path = str(root / "mask_final" / "b_subj.png") \
        if with_mask_path else None
    kw = dict(dataroot=str(root), img_path=img_path, mask_path=mask_path)
    jds = JEvalDataset(JConfig(**kw))
    want = [jds[i] for i in range(len(jds))]      # decoded with PIL
    monkeypatch.setitem(sys.modules, "PIL", None)
    got = EvalDataset(SuRSConfig(**kw))
    assert len(got) == len(want) == 1
    assert_items_equal(got[0], want[0])


def test_eval_dataset_jpg_without_pil_names_pil(tmp_path, monkeypatch):
    root = eval_root(tmp_path, names=("s",), ext="jpg")
    monkeypatch.setitem(sys.modules, "PIL", None)
    ds = EvalDataset(SuRSConfig(dataroot=str(root)))
    with pytest.raises(RuntimeError, match="PIL"):
        ds[0]


def test_config_dump_matches_jax():
    argv = ["--loadSize", "32", "--b_min", "-0.5", "-0.5", "-0.5",
            "--residual", "--no_mask_prune", "--name", "x",
            "--load_netG_checkpoint_path", "/ckpt/netG_latest"]
    cfg = parse_config(argv)
    assert cfg.loadSize == 32 and cfg.residual and not cfg.mask_prune
    assert print_config(cfg) == j_print_config(j_parse_config(argv))


# ------------------------------------------------------------------ CLI ---
def reference_checkpoint(path):
    """A reference-style state dict for the one-stack model, seeded
    (tests/test_torch_checkpoint.py's)."""
    with open(SPEC_PATH) as f:
        spec = json.load(f)
    extra = re.compile(
        r"^image_filter_lr\.(m|top_m_|conv_last|bn_end|l|bl|al)[12]\.")
    rng = np.random.default_rng(7)
    torch.save({k: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32) * 0.05)
        for k, shape in spec.items() if not extra.match(k)}, path)
    return path


def nearest_gap(a, b):
    return cKDTree(b).query(a)[0].max()


def test_cli_matches_the_jax_cli(tmp_path, monkeypatch, capsys):
    root = eval_root(tmp_path)
    ckpt = reference_checkpoint(str(tmp_path / "ref_netG"))
    args = ["--dataroot", str(root), "--name", "ev",
            "--load_netG_checkpoint_path", ckpt, *CLI_FLAGS]
    monkeypatch.setattr(sys, "argv", [
        "eval_surs.py", *args, "--results_path", str(tmp_path / "jax")])
    runpy.run_path(APP, run_name="__main__")
    capsys.readouterr()
    monkeypatch.setitem(sys.modules, "PIL", None)
    main([*args, "--results_path", str(tmp_path / "torch"),
          "--device", "cpu"])
    out = capsys.readouterr().out
    assert re.search(r"imported \d+ tensors from torch checkpoint", out)
    assert "test data size: 2" in out
    for name in ("a_subj", "b_subj"):
        assert f"saved {tmp_path / 'torch' / 'ev' / name}.obj" in out
        for suffix in ("_HR.obj", "_LR.obj"):
            vg, fg = load_obj(str(tmp_path / "torch" / "ev" / (name + suffix)))
            vw, fw = j_load_obj(str(tmp_path / "jax" / "ev" / (name + suffix)))
            assert fg.shape[0] > 0 and fg.shape == fw.shape
            assert vg.shape == vw.shape
            # as tests/test_torch_checkpoint.py: fields an ulp apart, a
            # vertex on a near-flat edge moves by up to 3 % of a cell
            assert max(nearest_gap(vg, vw), nearest_gap(vw, vg)) < 1e-3


def test_cli_runs_on_cuda_unless_told(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: main() would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--dataroot", str(eval_root(tmp_path))])


def test_cli_with_color_raises_naming_a11(tmp_path):
    """The color branch (ROADMAP.md A11) is ported: --with_color no
    longer raises by itself, and a netC file that is no reference
    ResBlkPIFuNet raises before any mesh is made, never a random color
    net (tests/test_torch_color.py holds the branch to the JAX CLI)."""
    netc = str(tmp_path / "netC")
    torch.save({"netC.conv0.weight": torch.zeros(3)}, netc)
    with pytest.raises(KeyError, match="unmappable netC key"):
        main(["--dataroot", str(eval_root(tmp_path)), "--with_color",
              "--load_netC_checkpoint_path", netc, "--device", "cpu",
              "--results_path", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists() or not any(
        (tmp_path / "out").rglob("*.obj"))


# ------------------------------------------------------ reconstruction API ---
@pytest.fixture(scope="module")
def services():
    jcfg = JConfig(serve_octree_mode="mono", mc_backend="device",
                   mc_algorithm="cubes", **COMMON)
    jsvc = JService(jcfg, compilation_cache=False)
    import jax
    params = jax.tree_util.tree_map(np.asarray, jsvc.params)
    tsvc = SuRSService(SuRSConfig(**COMMON), params=params, device="cpu")
    return jsvc, tsvc


TRANSFORM = np.array([[1.1, 0, 0, 0.01], [0, 0.9, 0, -0.02], [0, 0, 1.0, 0],
                      [0, 0, 0, 1]])


@pytest.mark.parametrize("transform,level", [(None, 0.5), (TRANSFORM, 0.5),
                                             (TRANSFORM, 0.48)])
def test_reconstruct_matches_jax(services, transform, level):
    jsvc, tsvc = services
    img, mask = subject()
    arr, _ = normalize_image(img, mask)
    j_arr, _ = j_normalize_image(img, mask)
    np.testing.assert_array_equal(arr, j_arr)
    calib = eval_calibration(1)
    _, j_lr, j_hr = jsvc.rec.encode(jsvc.params, jnp.asarray(j_arr))
    want = jsvc.rec.reconstruct(
        jsvc.weights, j_lr, j_hr, calib, 32, COMMON["b_min"],
        COMMON["b_max"], num_samples=4096, init_resolution=8,
        transform=transform, level=level, mc_backend="device",
        mc_caps={"algorithm": "cubes"})
    _, t_lr, t_hr = tsvc.rec.encode(arr)
    got = tsvc.rec.reconstruct(
        t_lr, t_hr, calib, 32, COMMON["b_min"], COMMON["b_max"],
        num_samples=4096, init_resolution=8, transform=transform,
        level=level, mc_backend="device", mc_caps={"algorithm": "cubes"})
    for i in (0, 2):
        vg, fg, vw, fw = got[i], got[i + 1], want[i], want[i + 1]
        assert fg.shape[0] > 0 and fg.shape == np.asarray(fw).shape
        assert vg.shape == np.asarray(vw).shape
        # raw float32 vertices (no OBJ rounding): the fields agree to
        # 1e-4 (tests/test_torch_pipeline.py)
        assert max(nearest_gap(vg, vw), nearest_gap(vw, vg)) < 2e-4
    func = reconstruction(tsvc.model, t_lr, t_hr, calib, 32,
                          COMMON["b_min"], COMMON["b_max"],
                          num_samples=4096, init_resolution=8,
                          transform=transform, level=level,
                          mc_backend="device",
                          mc_caps={"algorithm": "cubes"})
    for a, b in zip(func, got):
        np.testing.assert_array_equal(a, b)


def test_reconstruct_rejects_a_rotating_transform(services):
    _, tsvc = services
    arr, _ = normalize_image(*subject())
    _, t_lr, t_hr = tsvc.rec.encode(arr)
    rot = np.eye(4)
    rot[0, 1] = 0.1
    with pytest.raises(ValueError, match="axis-aligned"):
        tsvc.rec.reconstruct(t_lr, t_hr, eval_calibration(1), 32,
                             COMMON["b_min"], COMMON["b_max"],
                             transform=rot)


def test_functional_gen_mesh_equals_the_service(services, tmp_path):
    _, tsvc = services
    img, mask = subject()
    want = tsvc.reconstruct(img, mask, "s", str(tmp_path / "svc"))
    os.makedirs(tmp_path / "fn")
    got = gen_mesh(tsvc.cfg, tsvc.model, tsvc._data(img, mask),
                   str(tmp_path / "fn" / "s.obj"))
    for p, q in zip(got, want):
        assert open(p, "rb").read() == open(q, "rb").read()


def test_staged_extract_pair_yields_the_plain_meshes(services):
    _, tsvc = services
    sdf_hr, sdf_lr = tsvc.fields(*subject())
    mat = np.diag([1 / 32, 1 / 32, 1 / 32, 1.0])
    mat[:3, 3] = -0.5
    got = list(Reconstructor.extract_pair(sdf_hr, sdf_lr, mat,
                                          mc_backend="device",
                                          mc_caps={"algorithm": "cubes"}))
    for sdf, (verts, faces) in zip((sdf_hr, sdf_lr), got):
        v, f = marching_cubes(sdf, 0.5)
        want_v = (v.numpy() @ mat[:3, :3].T + mat[:3, 3]).astype(np.float32)
        assert faces.shape[0] > 0
        np.testing.assert_array_equal(verts, want_v)
        np.testing.assert_array_equal(faces, f.numpy())


@pytest.mark.parametrize("depth", [1, 2])
def test_writer_thread_equals_sequential(services, tmp_path, depth):
    _, tsvc = services
    items = [(*subject(seed=i, shift=i), f"s{i}") for i in range(4)]
    one = [tsvc.reconstruct(img, mask, name, str(tmp_path / "one"))
           for img, mask, name in items]
    stats = {}
    many = tsvc.reconstruct_many(items, str(tmp_path / "many"),
                                 pipeline=True, writer_thread=True,
                                 depth=depth, stats=stats)
    assert len(many) == 4 and len(stats["faces"]) == 8
    assert stats["write_s"] > 0
    for pair_one, pair_many in zip(one, many):
        for p, q in zip(pair_one, pair_many):
            assert os.path.basename(p) == os.path.basename(q)
            assert open(p, "rb").read() == open(q, "rb").read()
