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


# --------------------------------------------- the bf16 kernels' packing ---
@pytest.mark.parametrize("bf16", [False, True])
def test_hidden_stages_unpack_to_the_packed_blocks(mlps, bf16):
    """prepare_cols_weights' ring stages, read back through the
    documented index map (stage_index), are K1's [in, out] hidden blocks
    exactly, for both MLPs; the map is a permutation of each stage. In
    float32 (the 3xTF32 kernels' stages, tf32_stages) they read back as
    tf32_split's hi and lo of the blocks, each element in one stage
    (tests/test_torch_cols_tf32.py holds them stage by stage)."""
    _, _, t_lr, t_hr = mlps
    cw = fm.prepare_cols_weights(
        t_lr, t_hr, C_LR, dtype=torch.bfloat16 if bf16 else torch.float32)
    if not bf16:
        whid = cw.packed.whid
        assert tuple(whid.shape) == (2, len(fm.tf32_stages()),
                                     fm.TF32_STAGE)
        for m, (w, spec) in enumerate(((cw.fw.w_lr, cw.fw.spec_lr),
                                       (cw.fw.w_hr, cw.fw.spec_hr))):
            want = fm._hidden_blocks(w, spec, cw.fw.xk)
            got = fm.unpack_hidden_tf32(whid[m])
            for i in (1, 2, 3):
                assert torch.equal(torch.stack(fm.tf32_split(want[i])),
                                   got[i]), (m, i)
        return
    idx = fm.stage_index().reshape(-1)
    assert torch.equal(idx.sort().values, torch.arange(fm.STAGE_K
                                                       * fm.STAGE_N))
    whid = cw.packed.whid
    assert tuple(whid.shape) == (2, len(fm.hidden_stages()), 8192)
    assert whid.dtype == cw.fw.w_lr.dtype
    for m, (w, spec) in enumerate(((cw.fw.w_lr, cw.fw.spec_lr),
                                   (cw.fw.w_hr, cw.fw.spec_hr))):
        want = fm._hidden_blocks(w, spec, cw.fw.xk)
        got = fm.unpack_hidden(whid[m])
        for i in (1, 2, 3):
            assert torch.equal(got[i], want[i]), (m, i)
    # each stage is one [64, 128] block of W, every block covered once
    seen = {i: torch.zeros(DIMS_LR[i], DIMS_LR[i + 1], dtype=torch.int32)
            for i in (1, 2, 3)}
    for layer, k0, n0 in fm.hidden_stages():
        seen[layer][k0:k0 + fm.STAGE_K, n0:n0 + fm.STAGE_N] += 1
    assert all(bool((s == 1).all()) for s in seen.values())


def test_cols_packing_vectors(mlps):
    """cvec holds each term's depth row, prediction row (zero padding in
    the coarse MLP) and bias; hvec each MLP's b1 and w4h; wfeat the
    feature rows, transposed, zero past the terms: in float32 (the
    3xTF32 kernels') as tf32_split's hi and lo."""
    _, _, t_lr, t_hr = mlps
    cw = fm.prepare_cols_weights(t_lr, t_hr, C_LR)
    pk, fw = cw.packed, cw.fw
    for m, (w, b, spec) in enumerate(((fw.w_lr, fw.b_lr, fw.spec_lr),
                                      (fw.w_hr, fw.b_hr, fw.spec_hr))):
        layout = fm._layout(spec, fw.xk)
        for i, off in fm.TERM_LAYERS:
            _, xb, bo, n = layout[i]
            wx = w[xb[0]:xb[0] + fw.xk * n].view(fw.xk, n)
            o = m * fm.TERMS_MLP + off
            assert torch.equal(pk.wfeat[:, o:o + n],
                               torch.stack(fm.tf32_split(wx[:fm.FEAT].t())))
            assert torch.equal(pk.cvec[0, o:o + n], wx[fm.FEAT])
            assert torch.equal(pk.cvec[1, o:o + n], wx[fm.FEAT + 1])
            assert torch.equal(pk.cvec[2, o:o + n], b[bo:bo + n])
        assert torch.equal(pk.hvec[m, :512], b[1024:1536])
        h4 = layout[4][0]
        assert torch.equal(pk.hvec[m, 512:], w[h4[0]:h4[0] + 128])
    assert not pk.cvec[1, :fm.TERMS_MLP].any()
    assert not pk.wfeat[:, fm.TERMS_COLS:].any()


@pytest.mark.parametrize("with_kf", [False, True])
def test_column_terms_plain_matches_jax_column_product(mlps, with_kf):
    """The pre-pass's plain version against the column product of the
    JAX package's ``_cols_chain`` (``x_lr . W[seg0] + x_hr . W[seg1]``,
    ``+ kf * W[z_row]`` for windows, + the bias) at the rows
    ``_cols_layer_offsets`` names, layers 0, 2, 3, 4 of both MLPs,
    float32 at rtol 1e-5 / atol 1e-6."""
    jfw, fw = weights(mlps)
    _, _, t_lr, t_hr = mlps
    cw = fm.prepare_cols_weights(t_lr, t_hr, C_LR)
    x_lr, x_hr = features(5, seed=13)
    kf = (np.random.default_rng(14).standard_normal(5).astype(np.float32)
          if with_kf else None)
    want = np.zeros((5, fm.TERMS_COLS), np.float32)
    for m, (ws, bs, spec) in enumerate(((jfw.lr_w, jfw.lr_b, jfw.spec_lr),
                                        (jfw.hr_w, jfw.hr_b, jfw.spec_hr))):
        for i, off in fm.TERM_LAYERS:
            _, seg, z_row, _ = jfm._cols_layer_offsets(spec, i)
            W, n = ws[i], spec.dims[i + 1]
            col = (jnp.dot(jnp.asarray(x_lr), W[seg[0]:seg[0] + C_LR])
                   + jnp.dot(jnp.asarray(x_hr), W[seg[1]:seg[1] + C_HR]))
            if kf is not None:
                col = col + jnp.asarray(kf)[:, None] * W[z_row:z_row + 1]
            col = col + jnp.reshape(bs[i], (1, -1))
            o = m * fm.TERMS_MLP + off
            want[:, o:o + n] = np.asarray(col)[:, :n]
    got = fm.column_terms(torch.from_numpy(x_lr), torch.from_numpy(x_hr),
                          None if kf is None else torch.from_numpy(kf), cw)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,chunk", [(0, 32768), (1, 32768), (32768, 32768),
                                     (32769, 32768), (100000, 32768),
                                     (17, 4)])
def test_chunk_plan_covers_every_column_once(n, chunk):
    plan = fm.chunk_plan(n, chunk)
    hits = np.zeros(n, np.int64)
    for s, e in plan:
        assert 0 <= s < e <= n and e - s <= chunk
        hits[s:e] += 1
    assert (hits == 1).all()
    assert [s for s, _ in plan] == sorted(s for s, _ in plan)
    assert fm.chunk_plan(n) == fm.chunk_plan(n, fm.CHUNK_COLS)


def test_column_terms_need_the_packing(mlps):
    _, fw = weights(mlps)
    x_lr, x_hr = torch.zeros(2, C_LR), torch.zeros(2, C_HR)
    with pytest.raises(ValueError, match="ColsWeights"):
        fm.column_terms(x_lr, x_hr, None, fw)
    cw = fm.ColsWeights(fw, (C_LR, C_HR))      # no packing
    with pytest.raises(ValueError, match="ColsWeights"):
        fm.column_terms(x_lr, x_hr, None, cw)
