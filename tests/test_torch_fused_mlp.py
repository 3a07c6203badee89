"""Kernel K1's plain version (surs_tpu_torch/ops/fused_mlp.py) against
the Pallas kernel in interpret mode and its XLA twin, at the full
321/1024 widths, on the same weights through the bridge. Float32 at
rtol 1e-5 / atol 1e-6, the tolerance tests/test_fused_mlp.py holds the
Pallas kernel to. The CUDA kernel itself is held to this plain version
on the card by chip_smoke.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from surs_tpu.models import SurfaceClassifier as FlaxSurfaceClassifier
from surs_tpu.ops.fused_mlp import fused_dual_mlp as j_fused_dual_mlp
from surs_tpu.ops.fused_mlp import fused_dual_mlp_xla as j_fused_dual_mlp_xla
from surs_tpu.ops.fused_mlp import prepare_fused_weights as j_prepare
from surs_tpu_torch.compat.flax_import import load_flax_params
from surs_tpu_torch.models.surface_classifier import SurfaceClassifier
from surs_tpu_torch.ops.fused_mlp import (fused_dual_mlp, fused_dual_mlp_ref,
                                          prepare_fused_weights)

torch.set_num_threads(1)
DIMS_LR = (321, 1024, 512, 256, 128, 1)
DIMS_HR = (322, 1024, 512, 256, 128, 1)


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


def _inputs(n, seed=0):
    # feature-like inputs in the range the sampled maps produce
    return np.random.default_rng(seed).standard_normal(
        (n, 321)).astype(np.float32)


@pytest.mark.parametrize("n,split", [(300, None), (300, (256, 65)),
                                     (299, (256, 65)), (1, None)])
def test_plain_version_matches_pallas_and_xla(mlps, n, split):
    p_lr, p_hr, t_lr, t_hr = mlps
    x = _inputs(n)
    jfw = j_prepare(p_lr, p_hr, DIMS_LR, DIMS_HR, base_split=split)
    if split is None:
        jx = jnp.asarray(x)
        tx = torch.from_numpy(x)
    else:
        jx = [jnp.asarray(x[:, :256]), jnp.asarray(x[:, 256:])]
        tx = [torch.from_numpy(x[:, :256].copy()),
              torch.from_numpy(x[:, 256:].copy())]
    want_k = j_fused_dual_mlp(jx, jfw, block_n=256, interpret=True)
    want_x = j_fused_dual_mlp_xla(jx, jfw)
    got = fused_dual_mlp(tx, prepare_fused_weights(t_lr, t_hr))
    for g, wk, wx in zip(got, want_k, want_x):
        assert g.shape == (n,) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(wk), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(g.numpy(), np.asarray(wx), rtol=1e-5,
                                   atol=1e-6)


def test_plain_version_matches_model_chain(mlps):
    """The packed weights drive the same function as the two
    SurfaceClassifiers chained through pred_lr."""
    _, _, t_lr, t_hr = mlps
    x = torch.from_numpy(_inputs(128, seed=1))
    hr, lr = fused_dual_mlp_ref([x], prepare_fused_weights(t_lr, t_hr))
    with torch.no_grad():
        ref_lr = t_lr(x[None])[0, :, 0]
        ref_hr = t_hr(torch.cat([x, ref_lr[:, None]], -1)[None])[0, :, 0]
    np.testing.assert_allclose(lr.numpy(), ref_lr.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(hr.numpy(), ref_hr.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_bf16_weights_match_xla_twin(mlps):
    """bf16 weights: both sides round the input, each activation and
    pred_lr to bf16 and accumulate in float32; only the float32
    summation order differs, which can flip an activation's bf16
    rounding (a 2^-8 relative step). 2e-3 absolute on outputs in [0, 1]
    covers a few such flips."""
    p_lr, p_hr, t_lr, t_hr = mlps
    x = _inputs(300, seed=2)
    jfw = j_prepare(p_lr, p_hr, DIMS_LR, DIMS_HR, dtype=jnp.bfloat16,
                    base_split=(256, 65))
    want = j_fused_dual_mlp_xla([jnp.asarray(x[:, :256]),
                                 jnp.asarray(x[:, 256:])], jfw)
    fw = prepare_fused_weights(t_lr, t_hr, dtype=torch.bfloat16)
    assert fw.w_lr.dtype == torch.bfloat16 and fw.b_lr.dtype == torch.float32
    got = fused_dual_mlp([torch.from_numpy(x[:, :256].copy()),
                          torch.from_numpy(x[:, 256:].copy())], fw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=2e-3)


def test_packed_layout(mlps):
    """Each MLP packs [W0x, W1h, W2h, W2x, W3h, W3x, W4h, W4x] with the x
    blocks padded to 336 rows: the layout csrc/fused_dual_mlp.cu reads."""
    _, _, t_lr, t_hr = mlps
    fw = prepare_fused_weights(t_lr, t_hr)
    assert fw.xk == 336
    n_w = (336 * 1024 + 1024 * 512 + 512 * 256 + 336 * 256 + 256 * 128
           + 336 * 128 + 128 + 336)
    assert fw.w_lr.numel() == fw.w_hr.numel() == n_w
    assert fw.b_lr.numel() == 1024 + 512 + 256 + 128 + 1
    w0 = fw.w_hr[:336 * 1024].view(336, 1024)
    np.testing.assert_array_equal(w0[:322].numpy(),
                                  t_hr.conv0.weight.detach().t().numpy())
    assert not w0[322:].any()
    off = 336 * 1024 + 1024 * 512 + 512 * 256
    w2x = fw.w_lr[off:off + 336 * 256].view(336, 256)
    np.testing.assert_array_equal(
        w2x[:321].numpy(), t_lr.conv2.weight.detach().t()[512:].numpy())


def test_wrapper_rejects_bad_inputs(mlps):
    _, _, t_lr, t_hr = mlps
    fw = prepare_fused_weights(t_lr, t_hr)
    with pytest.raises(ValueError, match="do not make"):
        fused_dual_mlp(torch.zeros(4, 320), fw)
    # neither CPU nor CUDA: no plain-version fallback
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fused_dual_mlp(torch.zeros(4, 321, device="meta"), fw)


def test_cpu_tensors_take_the_plain_version(mlps):
    _, _, t_lr, t_hr = mlps
    before = fused_dual_mlp.launches
    fused_dual_mlp(torch.zeros(8, 321), prepare_fused_weights(t_lr, t_hr))
    assert fused_dual_mlp.launches == before
