"""The port's service (surs_tpu_torch/serve.py) against the JAX
SuRSService on the same weights (through the bridge) and the same
subject: mono octree, classic marching cubes on the device, a +-0.5 box
and a silhouette mask. Fields at atol 1e-4 (float32 encode and MLP in a
different summation order); the OBJ pairs are non-empty, have the same
face counts and allclose vertices. Also the port's own rules: the CUDA
default, the auto table, the values that raise and those that now
resolve (dense and runs-mode evaluation)."""

import dataclasses
import os

import numpy as np
import jax
import pytest
import torch
from scipy.spatial import cKDTree

from surs_tpu.config import SuRSConfig as JConfig
from surs_tpu.recon.mesh_io import load_obj
from surs_tpu.serve import SuRSService as JService
from surs_tpu_torch.config import SuRSConfig, resolve_config, resolve_device
from surs_tpu_torch.serve import SuRSService

torch.set_num_threads(1)
S = 16
COMMON = dict(loadSize=32, num_stack_lr=1, resolution=32,
              octree_init_resolution=8, num_samples=4096,
              b_min=[-0.5, -0.5, -0.5], b_max=[0.5, 0.5, 0.5],
              mask_prune=True, dtype="float32", feature_dtype="float32",
              seed=2)


def subject():
    rng = np.random.default_rng(0)
    img = (rng.random((S, S, 3)) * 255).astype(np.uint8)
    yy, xx = np.mgrid[:S, :S]
    mask = (((xx - S / 2) / (S * 0.3)) ** 2 + ((yy - S / 2) / (S * 0.42)) ** 2
            < 1).astype(np.uint8) * 255
    return img, mask


@pytest.fixture(scope="module")
def services():
    jcfg = JConfig(serve_octree_mode="mono", mc_backend="device",
                   mc_algorithm="cubes", **COMMON)
    jsvc = JService(jcfg, compilation_cache=False)
    params = jax.tree_util.tree_map(np.asarray, jsvc.params)
    tsvc = SuRSService(SuRSConfig(**COMMON), params=params, device="cpu")
    return jsvc, tsvc


def nearest_gap(a, b):
    """Largest distance from a vertex of ``a`` to its nearest in ``b``."""
    return cKDTree(b).query(a)[0].max()


def test_fields_match_jax(services):
    jsvc, tsvc = services
    img, mask = subject()
    want = jsvc.fields(img, mask)
    got = tsvc.fields(img, mask)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (32, 32, 32)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
    assert (got[0].numpy() == 0).any()           # the mask pruned voxels


def test_obj_pair_matches_jax(services, tmp_path):
    jsvc, tsvc = services
    img, mask = subject()
    want = jsvc.reconstruct(img, mask, "subj", str(tmp_path / "jax"))
    got = tsvc.reconstruct(img, mask, "subj", str(tmp_path / "torch"))
    for g, w in zip(got, want):
        assert g.endswith(os.path.basename(w))
        vg, fg = load_obj(g)
        vw, fw = load_obj(w)
        assert fg.shape[0] > 0 and fg.shape == fw.shape
        # the same vertex set, up to the fields' float32 differences and
        # the OBJ's 4 decimals
        assert vg.shape == vw.shape
        assert max(nearest_gap(vg, vw), nearest_gap(vw, vg)) < 2e-4


@pytest.mark.parametrize("pipeline", [False, True])
def test_reconstruct_many_equals_reconstruct(services, tmp_path, pipeline):
    _, tsvc = services
    img, mask = subject()
    one = tsvc.reconstruct(img, mask, "a", str(tmp_path / "one"))
    many = tsvc.reconstruct_many(
        [(img, mask, "a"), (img[::-1].copy(), mask, "b")],
        str(tmp_path / "many"), pipeline=pipeline)
    assert [os.path.basename(p) for p in many[0]] == ["a_HR.obj", "a_LR.obj"]
    for p, q in zip(one, many[0]):
        assert open(p, "rb").read() == open(q, "rb").read()
    assert all(os.path.exists(p) for p in many[1])


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SuRSService(SuRSConfig(**COMMON))


def test_auto_table():
    cfg = SuRSConfig()
    cpu = resolve_config(cfg, "cpu")
    cuda = resolve_config(cfg, "cuda")
    assert (cpu.dtype, cpu.feature_dtype) == ("float32", "float32")
    assert (cuda.dtype, cuda.feature_dtype) == ("bfloat16", "bfloat16")
    for c in (cpu, cuda):
        assert (c.serve_octree_mode, c.mc_backend, c.mc_algorithm) == (
            "mono", "device", "cubes")


@pytest.mark.parametrize("field,value", [
    ("mc_backend", "sharded"), ("remat", True),
    ("remat_encoder", True), ("with_color", True)])
def test_unported_values_raise(field, value):
    """Every value that once raised naming its ROADMAP.md item is ported
    and resolves: mc_backend 'sharded' (A13), remat and remat_encoder
    (A19), with_color (A11)."""
    cfg = dataclasses.replace(SuRSConfig(), **{field: value})
    assert getattr(resolve_config(cfg, "cpu"), field) == value


@pytest.mark.parametrize("field,value", [
    ("octree_mode", "runs"), ("serve_octree_mode", "runs"),
    ("use_octree", False), ("mc_algorithm", "tets"),
    ("mc_backend", "host")])
def test_dense_and_runs_values_resolve(field, value):
    cfg = resolve_config(dataclasses.replace(SuRSConfig(), **{field: value}),
                         "cpu")
    assert getattr(cfg, field) == value


def test_batch_norm_trunk_raises():
    """Batch-norm trunks are ported (ROADMAP.md A16): the service builds
    one and serves a field; tests/test_torch_configs.py holds it to the
    JAX service."""
    svc = SuRSService(dataclasses.replace(SuRSConfig(**COMMON), norm="batch"),
                      device="cpu")
    assert hasattr(svc.model.image_filter_lr.conv2.bn1, "bn")
    img, mask = subject()
    sdf_hr, sdf_lr = svc.fields(img, mask)
    assert tuple(sdf_lr.shape) == (32, 32, 32)
    assert bool(torch.isfinite(sdf_hr).all() & torch.isfinite(sdf_lr).all())
