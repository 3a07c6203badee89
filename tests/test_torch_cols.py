"""Kernels K3 and K4's plain versions (surs_tpu_torch/ops/fused_mlp.py)
against the Pallas kernels ``fused_dual_mlp_cols`` / ``fused_dual_mlp_runs``
in interpret mode and their XLA twins, at the full 321/1024 widths, on
the same weights through the bridge. Float32 at rtol 1e-5 / atol 1e-6,
the tolerance tests/test_fused_mlp.py holds the Pallas kernels to. The
CUDA kernels themselves are held to these plain versions on the card by
chip_smoke.py (phases k3, k4)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from surs_tpu.models import SurfaceClassifier as FlaxSurfaceClassifier
from surs_tpu.ops import fused_mlp as jfm
from surs_tpu_torch.compat.flax_import import load_flax_params
from surs_tpu_torch.models.surface_classifier import SurfaceClassifier
from surs_tpu_torch.ops import fused_mlp as fm

torch.set_num_threads(1)
DIMS_LR = (321, 1024, 512, 256, 128, 1)
DIMS_HR = (322, 1024, 512, 256, 128, 1)
C_LR, C_HR = 256, 64


@pytest.fixture(scope="module")
def mlps():
    p_lr = FlaxSurfaceClassifier(DIMS_LR).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 321)))["params"]
    p_hr = FlaxSurfaceClassifier(DIMS_HR).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 4, 322)))["params"]
    p_lr = jax.tree_util.tree_map(np.asarray, p_lr)
    p_hr = jax.tree_util.tree_map(np.asarray, p_hr)
    t_lr = load_flax_params(SurfaceClassifier(DIMS_LR), p_lr)
    t_hr = load_flax_params(SurfaceClassifier(DIMS_HR), p_hr)
    return p_lr, p_hr, t_lr, t_hr


def weights(mlps, bf16=False):
    p_lr, p_hr, t_lr, t_hr = mlps
    jfw = jfm.prepare_fused_weights(
        p_lr, p_hr, DIMS_LR, DIMS_HR, base_split=(C_LR, C_HR, 1),
        dtype=jnp.bfloat16 if bf16 else jnp.float32)
    cw = fm.prepare_cols_weights(
        t_lr, t_hr, C_LR, dtype=torch.bfloat16 if bf16 else torch.float32)
    return jfw, cw.fw


def features(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, C_LR)).astype(np.float32),
            rng.standard_normal((n, C_HR)).astype(np.float32))


def close(got, wants, rtol=1e-5, atol=1e-6):
    for g, *ws in zip(got, *wants):
        assert g.dtype == torch.float32
        for w in ws:
            assert tuple(g.shape) == np.asarray(w).shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                                       atol=atol)


@pytest.mark.parametrize("ncol,z", [(6, 16), (3, 8)])
def test_cols_plain_matches_pallas_and_xla(mlps, ncol, z):
    jfw, fw = weights(mlps)
    x_lr, x_hr = features(ncol, seed=ncol)
    zf = np.random.default_rng(z).standard_normal(z).astype(np.float32)
    j_args = (jnp.asarray(x_lr), jnp.asarray(x_hr), jnp.asarray(zf), jfw)
    want_k = jfm.fused_dual_mlp_cols(*j_args, col_block=2, interpret=True)
    want_x = jfm.fused_dual_mlp_cols_xla(*j_args)
    got = fm.fused_dual_mlp_cols(torch.from_numpy(x_lr),
                                 torch.from_numpy(x_hr),
                                 torch.from_numpy(zf), fw)
    close(got, (want_k, want_x))


def test_cols_plain_matches_xla_at_depth_512(mlps):
    jfw, fw = weights(mlps)
    x_lr, x_hr = features(2, seed=3)
    zf = np.linspace(-1.0, 1.0, 512).astype(np.float32)
    want = jfm.fused_dual_mlp_cols_xla(jnp.asarray(x_lr), jnp.asarray(x_hr),
                                       jnp.asarray(zf), jfw)
    got = fm.fused_dual_mlp_cols_ref(torch.from_numpy(x_lr),
                                     torch.from_numpy(x_hr),
                                     torch.from_numpy(zf), fw)
    close(got, (want,))


def test_cols_bf16_matches_pallas(mlps):
    """bf16 weights: both sides cast the features and each activation to
    bf16, round the depth term zf * w_z to bf16 and keep pred_lr in
    float32, accumulating in float32. Only the summation order differs,
    which can flip an activation's bf16 rounding (a 2^-8 relative step);
    2e-3 absolute on outputs in [0, 1] covers a few such flips, as for
    K1."""
    jfw, fw = weights(mlps, bf16=True)
    x_lr, x_hr = features(4, seed=5)
    zf = np.linspace(-1.2, 1.2, 16).astype(np.float32)
    want = jfm.fused_dual_mlp_cols(jnp.asarray(x_lr), jnp.asarray(x_hr),
                                   jnp.asarray(zf), jfw, col_block=2,
                                   interpret=True)
    assert fw.w_lr.dtype == torch.bfloat16
    got = fm.fused_dual_mlp_cols(torch.from_numpy(x_lr),
                                 torch.from_numpy(x_hr),
                                 torch.from_numpy(zf), fw)
    close(got, (want,), rtol=0, atol=2e-3)


def runs_inputs(nr, zb, seed):
    x_lr, x_hr = features(nr, seed)
    rng = np.random.default_rng(seed + 100)
    kf = rng.standard_normal(nr).astype(np.float32)
    zt = np.linspace(-0.3, 0.3, zb).astype(np.float32)
    return x_lr, x_hr, kf, zt


@pytest.mark.parametrize("nr", [5, 1])
def test_runs_plain_matches_pallas_and_xla(mlps, nr):
    jfw, fw = weights(mlps)
    arrs = runs_inputs(nr, 8, seed=nr)
    j_args = [jnp.asarray(a) for a in arrs] + [jfw]
    want_k = jfm.fused_dual_mlp_runs(*j_args, run_block=2, interpret=True)
    want_x = jfm.fused_dual_mlp_runs_xla(*j_args)
    got = fm.fused_dual_mlp_runs(*[torch.from_numpy(a) for a in arrs], fw)
    close(got, (want_k, want_x))


def test_runs_bf16_matches_pallas(mlps):
    """bf16: as K3's case. The TPU kernel carries kf in an hr pad lane,
    which needs float32 features; the port takes kf as its own float32
    input, unrounded, so both sides agree on it."""
    jfw, fw = weights(mlps, bf16=True)
    arrs = runs_inputs(5, 8, seed=7)
    want = jfm.fused_dual_mlp_runs(*[jnp.asarray(a) for a in arrs], jfw,
                                   run_block=2, interpret=True)
    got = fm.fused_dual_mlp_runs(*[torch.from_numpy(a) for a in arrs], fw)
    close(got, (want,), rtol=0, atol=2e-3)


def test_runs_equals_cols_at_shifted_depths(mlps):
    """A window at offset kf scores what K3 scores at depths kf + zt:
    the two plain versions share one chain."""
    _, fw = weights(mlps)
    x_lr, x_hr, kf, zt = [torch.from_numpy(a) for a in runs_inputs(3, 8, 9)]
    kf = torch.zeros_like(kf)
    hr, lr = fm.fused_dual_mlp_runs(x_lr, x_hr, kf, zt, fw)
    c_hr, c_lr = fm.fused_dual_mlp_cols(x_lr, x_hr, zt, fw)
    np.testing.assert_allclose(hr.numpy(), c_hr.numpy(), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(lr.numpy(), c_lr.numpy(), rtol=1e-6,
                               atol=1e-7)


def test_plain_versions_chunk_columns(mlps, monkeypatch):
    """The plain versions score columns in chunks of about
    _REF_CHUNK_ROWS points; chunking changes nothing but the blocking of
    the float32 products (a few ulp)."""
    _, fw = weights(mlps)
    x_lr, x_hr, kf, zt = [torch.from_numpy(a) for a in runs_inputs(7, 8, 11)]
    whole_c = fm.fused_dual_mlp_cols(x_lr, x_hr, zt, fw)
    whole_r = fm.fused_dual_mlp_runs(x_lr, x_hr, kf, zt, fw)
    monkeypatch.setattr(fm, "_REF_CHUNK_ROWS", 16)     # 2 columns a chunk
    for a, b in zip(fm.fused_dual_mlp_cols(x_lr, x_hr, zt, fw) +
                    fm.fused_dual_mlp_runs(x_lr, x_hr, kf, zt, fw),
                    whole_c + whole_r):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)
    empty = fm.fused_dual_mlp_cols(x_lr[:0], x_hr[:0], zt, fw)
    assert [tuple(e.shape) for e in empty] == [(0, 8), (0, 8)]


def test_cols_weights_are_k1_packing(mlps):
    _, _, t_lr, t_hr = mlps
    cw = fm.prepare_cols_weights(t_lr, t_hr, 256)
    assert cw.split == (256, 64)
    k1 = fm.prepare_fused_weights(t_lr, t_hr)
    assert torch.equal(cw.fw.w_hr, k1.w_hr) and cw.fw.xk == 336
    with pytest.raises(ValueError, match="no hr features"):
        fm.prepare_cols_weights(t_lr, t_hr, 320)


def test_wrappers_reject_bad_inputs(mlps):
    _, fw = weights(mlps)
    z = torch.zeros(8)
    with pytest.raises(ValueError, match="features"):
        fm.fused_dual_mlp_cols(torch.zeros(2, 256), torch.zeros(2, 65), z,
                               fw)
    with pytest.raises(ValueError, match="depth input"):
        fm.fused_dual_mlp_runs(torch.zeros(2, 256), torch.zeros(2, 64),
                               torch.zeros(3), z, fw)
    # neither CPU nor CUDA: no plain-version fallback
    meta = torch.zeros(2, 256, device="meta"), torch.zeros(2, 64,
                                                           device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fm.fused_dual_mlp_cols(*meta, z.to("meta"), fw)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fm.fused_dual_mlp_runs(*meta, torch.zeros(2, device="meta"),
                               z.to("meta"), fw)


def test_cpu_tensors_take_the_plain_versions(mlps):
    _, fw = weights(mlps)
    before = (fm.fused_dual_mlp_cols.launches,
              fm.fused_dual_mlp_runs.launches)
    x_lr, x_hr = torch.zeros(2, 256), torch.zeros(2, 64)
    fm.fused_dual_mlp_cols(x_lr, x_hr, torch.zeros(8), fw)
    fm.fused_dual_mlp_runs(x_lr, x_hr, torch.zeros(2), torch.zeros(8), fw)
    assert (fm.fused_dual_mlp_cols.launches,
            fm.fused_dual_mlp_runs.launches) == before
