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
from surs_tpu_torch.ops import fused_mlp as fm
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


# ------------------------------------------ the bf16 K1's ring stages ---
def _k1_shapes():
    d = DIMS_LR
    return {"0x": (320, d[1]), "1h": (d[1], d[2]), "2h": (d[2], d[3]),
            "2x": (320, d[3]), "3h": (d[3], d[4]), "3x": (320, d[4])}


def test_k1_packing_only_for_bf16_at_kernel_widths(mlps, monkeypatch):
    """K1's packing at the kernel's widths: K1Packed in bf16 on any
    device; in float32 the float32 K3/K4's ColsPackedTF32, built only for
    weights on the card (forced here), never on the CPU."""
    _, _, t_lr, t_hr = mlps
    assert prepare_fused_weights(t_lr, t_hr).packed is None
    monkeypatch.setattr(fm, "_packs_f32_k1", lambda dev: True)
    assert isinstance(prepare_fused_weights(t_lr, t_hr).packed,
                      fm.ColsPackedTF32)
    narrow = (SurfaceClassifier((321, 64, 32, 16, 8, 1)),
              SurfaceClassifier((322, 64, 32, 16, 8, 1)))
    for dtype in (torch.float32, torch.bfloat16):
        assert prepare_fused_weights(*narrow, dtype=dtype).packed is None
    pk = prepare_fused_weights(t_lr, t_hr, dtype=torch.bfloat16).packed
    assert isinstance(pk, fm.K1Packed)
    assert tuple(pk.stages.shape) == (2, fm.K1_STAGES, 8192)
    assert pk.stages.dtype == torch.bfloat16
    assert pk.nbytes.dtype == torch.int32 and pk.vec.dtype == torch.float32
    assert tuple(pk.vec.shape) == (2, fm.K1_VEC)


@pytest.mark.parametrize("mlp", [0, 1])
def test_k1_stages_hold_every_weight_once(mlps, mlp):
    """The stages, read back through the documented index map, are K1's
    blocks exactly (the x blocks' 320 feature rows, the hidden blocks):
    every element once, W0x's twice (layer 0 is built once per half of
    layer 1); each stage's map is a permutation of its kw * nw first
    elements, the rest zero, and nbytes says how many bytes the producer
    copies."""
    _, _, t_lr, t_hr = mlps
    fw = prepare_fused_weights(t_lr, t_hr, dtype=torch.bfloat16)
    w, spec = ((fw.w_lr, fw.spec_lr), (fw.w_hr, fw.spec_hr))[mlp]
    plan = fm.k1_stages()
    assert len(plan) == fm.K1_STAGES
    stages = fw.packed.stages[mlp]
    got = fm.unpack_stages(stages, plan, _k1_shapes())
    want = fm.k1_blocks(w, spec, fw.xk)
    seen = {k: torch.zeros(s, dtype=torch.int32)
            for k, s in _k1_shapes().items()}
    for s, (key, k0, n0, kw, nw) in enumerate(plan):
        idx = fm.stage_index(None, kw, nw).reshape(-1)
        assert torch.equal(idx.sort().values, torch.arange(kw * nw))
        assert not stages[s, kw * nw:].any()
        assert int(fw.packed.nbytes[s]) == kw * nw * 2
        seen[key][k0:k0 + kw, n0:n0 + nw] += 1
    for key in want:
        assert bool((seen[key] == (2 if key == "0x" else 1)).all()), key
        assert torch.equal(got[key], want[key]), key


def test_k1_vec_holds_the_epilogue_rows(mlps):
    """vec: each input-reading layer's bias, depth row (x row 320) and
    prediction row (x row 321, zero padding in the coarse MLP); b1; w4h;
    w4x's feature rows; then b4 and w4x's depth and prediction rows."""
    _, _, t_lr, t_hr = mlps
    fw = prepare_fused_weights(t_lr, t_hr, dtype=torch.bfloat16)
    o = fm.K1_VEC_OFF
    for m, (w, b, spec) in enumerate(((fw.w_lr, fw.b_lr, fw.spec_lr),
                                      (fw.w_hr, fw.b_hr, fw.spec_hr))):
        v = fw.packed.vec[m]
        layout = fm._layout(spec, fw.xk)
        for i in (0, 2, 3, 4):
            _, xb, bo, n = layout[i]
            wx = w[xb[0]:xb[0] + fw.xk * n].view(fw.xk, n).float()
            if i < 4:
                assert torch.equal(v[o[f"b{i}"]:o[f"b{i}"] + n], b[bo:bo + n])
                assert torch.equal(v[o[f"z{i}"]:o[f"z{i}"] + n], wx[320])
                assert torch.equal(v[o[f"p{i}"]:o[f"p{i}"] + n], wx[321])
            else:
                assert torch.equal(v[o["w4x"]:o["w4x"] + 320], wx[:320, 0])
                assert torch.equal(v[o["tail"]:o["tail"] + 4], torch.stack(
                    [b[bo], wx[320, 0], wx[321, 0], torch.tensor(0.)]))
        assert torch.equal(v[o["b1"]:o["b1"] + 512], b[1024:1536])
        h4 = layout[4][0]
        assert torch.equal(v[o["w4h"]:o["w4h"] + 128],
                           w[h4[0]:h4[0] + 128].float())
    assert not fw.packed.vec[0, o["p0"]:o["p0"] + 1024].any()


def _leaky(v):
    return torch.where(v >= 0, v, 0.01 * v)


def k1_staged_ref(x, pk):
    """K1 from the bf16 kernel's buffers alone, in its order: layer 0 by
    64-wide slices, once per 256-wide half of layer 1; the feature
    products apart from the depth and prediction columns' rank-1 terms.
    x [N, 321] float32 -> (pred_hr, pred_lr)."""
    bf = torch.bfloat16
    xr = x.to(bf).float()
    X, z = xr[:, :320], xr[:, 320:321]
    o = fm.K1_VEC_OFF

    def mlp(m, p):
        W = {k: t.float() for k, t in fm.unpack_stages(
            pk.stages[m], fm.k1_stages(), _k1_shapes()).items()}
        v = pk.vec[m]

        def terms(i, n):
            return (v[o[f"b{i}"]:o[f"b{i}"] + n] + z * v[o[f"z{i}"]:
                    o[f"z{i}"] + n] + p * v[o[f"p{i}"]:o[f"p{i}"] + n])

        t0 = terms(0, 1024)
        h1 = []
        for half in range(2):
            acc = torch.zeros(x.shape[0], 256)
            for kc in range(16):
                ks = slice(64 * kc, 64 * kc + 64)
                a0 = _leaky(X @ W["0x"][:, ks] + t0[:, ks]).to(bf).float()
                acc = acc + a0 @ W["1h"][ks, 256 * half:256 * half + 256]
            b1 = v[o["b1"] + 256 * half:o["b1"] + 256 * half + 256]
            h1.append(_leaky(acc + b1).to(bf).float())
        h1 = torch.cat(h1, 1)
        h2 = _leaky(h1 @ W["2h"] + X @ W["2x"] + terms(2, 256)).to(bf).float()
        h3 = _leaky(h2 @ W["3h"] + X @ W["3x"] + terms(3, 128)).to(bf).float()
        tail = v[o["tail"]:o["tail"] + 3]
        logit = (h3 @ v[o["w4h"]:o["w4h"] + 128]
                 + X @ v[o["w4x"]:o["w4x"] + 320]
                 + tail[0] + z[:, 0] * tail[1] + p[:, 0] * tail[2])
        return torch.sigmoid(logit)

    lr = mlp(0, torch.zeros_like(z))
    hr = mlp(1, lr[:, None].to(bf).float())
    return hr, lr


@pytest.mark.parametrize("n", [1, 129, 300])
def test_k1_kernel_order_matches_pallas(mlps, n):
    """The bf16 K1's arithmetic from its stages and epilogue rows alone
    (k1_staged_ref) against the Pallas kernel in interpret mode on bf16
    weights: both round the input, every activation and pred_lr to bf16
    and sum in float32, in other orders, which can flip an activation's
    bf16 rounding now and then; 5e-3 absolute, the card's K1 tolerance."""
    p_lr, p_hr, t_lr, t_hr = mlps
    x = _inputs(n, seed=5)
    jfw = j_prepare(p_lr, p_hr, DIMS_LR, DIMS_HR, dtype=jnp.bfloat16,
                    base_split=(256, 65))
    want = j_fused_dual_mlp([jnp.asarray(x[:, :256]), jnp.asarray(x[:, 256:])],
                            jfw, block_n=256, interpret=True)
    fw = prepare_fused_weights(t_lr, t_hr, dtype=torch.bfloat16)
    got = k1_staged_ref(torch.from_numpy(x), fw.packed)
    for g, w in zip(got, want):
        assert g.shape == (n,)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=5e-3)
