"""The float32 K3/K4's 3xTF32 arithmetic (surs_tpu_torch/ops/fused_mlp.py:
the ColsPackedTF32 packing, tf32_stages, unpack_hidden_tf32, the pre-pass's
plain version and the composed plain versions fused_dual_mlp_cols_tf32x3_ref
/ fused_dual_mlp_runs_tf32x3_ref) on the CPU: against the float32 plain
versions, against the JAX package's float32 ``fused_dual_mlp_cols`` /
``fused_dual_mlp_runs`` (Pallas in interpret mode and the XLA twins), and a
numpy model of one tile of the chain kernel's data movement (fragment
layouts, the k permutation, the stage order, layer 2's per-thread sums).
The CUDA kernels themselves are held to the float32 plain versions on the
card by chip_smoke.py (phases k3, k4, dense, runs).

Tolerances: the packing is bit-exact (integer split on both sides). The
3xTF32 chain keeps each product to about 2^-21 relative (lo.lo dropped,
each split 2^-22), so it agrees with the float32 chains to 1e-5 on
outputs in [0, 1], COLS_TOL["float32"] in chip_smoke.py, at rtol 1e-5 /
atol 1e-6 as tests/test_torch_cols.py holds the float32 plain versions."""

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
TOL = 1e-5


@pytest.fixture(scope="module")
def case():
    """Flax-initialised MLPs scaled by 3 (outputs over (0, 1), as
    chip_smoke.py's kernel_mlps), carried into the port by the bridge;
    both packings of the same float32 weights."""
    rng = np.random.default_rng(19)
    p_lr = FlaxSurfaceClassifier(DIMS_LR).init(
        jax.random.PRNGKey(2), jnp.zeros((1, 4, 321)))["params"]
    p_hr = FlaxSurfaceClassifier(DIMS_HR).init(
        jax.random.PRNGKey(3), jnp.zeros((1, 4, 322)))["params"]
    p_lr, p_hr = (jax.tree_util.tree_map(lambda a: 3.0 * np.asarray(a), p)
                  for p in (p_lr, p_hr))
    t_lr = load_flax_params(SurfaceClassifier(DIMS_LR), p_lr)
    t_hr = load_flax_params(SurfaceClassifier(DIMS_HR), p_hr)
    jfw = jfm.prepare_fused_weights(p_lr, p_hr, DIMS_LR, DIMS_HR,
                                    base_split=(C_LR, C_HR, 1))
    cw = fm.prepare_cols_weights(t_lr, t_hr, C_LR)
    return rng, jfw, cw


def features(rng, n):
    return (rng.standard_normal((n, C_LR)).astype(np.float32),
            rng.standard_normal((n, C_HR)).astype(np.float32))


def close(got, wants, tol=TOL):
    for g, *ws in zip(got, *wants):
        assert g.dtype == torch.float32
        for w in ws:
            w = np.asarray(w)
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), w, rtol=tol, atol=0.1 * tol)


def tile_offset(n, k):
    """Float offset of element (n, k) of a [128 n x 32 k] tile: 128-byte
    rows, 16-byte chunk c of row n at chunk c ^ (n % 8) (the swizzle the
    wgmma descriptor reads)."""
    return n * 32 + ((k // 4) ^ (n % 8)) * 4 + k % 4


# ------------------------------------------------------------ packing ---
def test_packing_is_tf32_split_stage_by_stage(case):
    """Every one of the 168 stages of each MLP is hi then lo of
    ``tf32_split`` of its [32 k x 128 n] block of W1h / W2h / W3h, k rows
    permuted within each 8 by TF32_KPERM, at the documented tile offsets;
    bit for bit."""
    _, _, cw = case
    pk = cw.packed
    assert isinstance(pk, fm.ColsPackedTF32)
    assert tuple(pk.whid.shape) == (2, 168, fm.TF32_STAGE)
    assert pk.whid.dtype == torch.float32
    n = np.arange(128)[None, :]
    k = np.arange(32)[:, None]
    off = tile_offset(n, k)                       # [32 k, 128 n]
    perm = np.asarray(fm.TF32_KPERM)
    rows = 8 * (np.arange(32) // 8) + perm[np.arange(32) % 8]
    for m, (w, spec) in enumerate(((cw.fw.w_lr, cw.fw.spec_lr),
                                   (cw.fw.w_hr, cw.fw.spec_hr))):
        blocks = fm._hidden_blocks(w, spec, cw.fw.xk)
        split = {i: [p.numpy().view(np.uint32) for p in fm.tf32_split(b)]
                 for i, b in blocks.items()}
        stages = pk.whid[m].numpy().view(np.uint32)
        for s, (layer, k0, n0) in enumerate(fm.tf32_stages()):
            for h in range(2):
                want = split[layer][h][k0 + rows][:, n0:n0 + 128]
                got = stages[s, h * 4096:(h + 1) * 4096][off]
                np.testing.assert_array_equal(got, want, err_msg=(m, s, h))
        got = fm.unpack_hidden_tf32(pk.whid[m])
        for i in (1, 2, 3):
            hi, lo = fm.tf32_split(blocks[i])
            assert torch.equal(got[i][0], hi) and torch.equal(got[i][1], lo)


def test_tf32_stages_cover_each_block_once():
    """The stage order: per 128-output chunk c of layer 1 its 32 k-stages,
    then layer 2's 8 stages over k [128 c, 128 c + 128); layer 3 last;
    every [in, out] element of the hidden blocks in exactly one stage."""
    plan = fm.tf32_stages()
    assert len(plan) == 168
    assert plan[:33] == [(1, 32 * kc, 0) for kc in range(32)] + [(2, 0, 0)]
    assert plan[32:40] == [(2, k0, n0) for n0 in (0, 128)
                           for k0 in (0, 32, 64, 96)]
    assert plan[-8:] == [(3, 32 * kc, 0) for kc in range(8)]
    seen = {i: np.zeros((DIMS_LR[i], DIMS_LR[i + 1]), np.int64)
            for i in (1, 2, 3)}
    for layer, k0, n0 in plan:
        seen[layer][k0:k0 + 32, n0:n0 + 128] += 1
    assert all((v == 1).all() for v in seen.values())
    assert sorted(fm.TF32_KPERM) == list(range(8))


def test_feature_rows_and_vectors(case):
    """wfeat holds tf32_split (hi, lo) of each term's feature rows,
    transposed, zero past the terms; cvec and hvec are the float32
    vectors of the bf16 packing's layout."""
    _, _, cw = case
    pk = cw.packed
    assert tuple(pk.wfeat.shape) == (2, fm.TERMS_ROWS, fm.FEAT)
    fw = cw.fw
    for m, (w, b, spec) in enumerate(((fw.w_lr, fw.b_lr, fw.spec_lr),
                                      (fw.w_hr, fw.b_hr, fw.spec_hr))):
        layout = fm._layout(spec, fw.xk)
        for i, o in fm.TERM_LAYERS:
            _, xb, bo, n = layout[i]
            wx = w[xb[0]:xb[0] + fw.xk * n].view(fw.xk, n)
            o += m * fm.TERMS_MLP
            hi, lo = fm.tf32_split(wx[:fm.FEAT].t())
            assert torch.equal(pk.wfeat[0, o:o + n], hi)
            assert torch.equal(pk.wfeat[1, o:o + n], lo)
            assert torch.equal(pk.cvec[0, o:o + n], wx[fm.FEAT])
            assert torch.equal(pk.cvec[1, o:o + n], wx[fm.FEAT + 1])
            assert torch.equal(pk.cvec[2, o:o + n], b[bo:bo + n])
        h4 = layout[4][0]
        assert torch.equal(pk.hvec[m], torch.cat([b[1024:1536],
                                                  w[h4[0]:h4[0] + 128]]))
    assert not pk.wfeat[:, fm.TERMS_COLS:].any()


# ------------------------------------------------- the plain versions ---
@pytest.mark.parametrize("with_kf", [False, True])
def test_column_terms_tf32x3_against_float64(case, with_kf):
    """The pre-pass's 3xTF32 plain version against the same terms in
    float64: within 2e-6 of the largest term (each product to 2^-21, 320
    of them)."""
    rng, _, cw = case
    x_lr, x_hr = features(rng, 7)
    kf = rng.standard_normal(7).astype(np.float32) if with_kf else None
    got = fm.column_terms(torch.from_numpy(x_lr), torch.from_numpy(x_hr),
                          None if kf is None else torch.from_numpy(kf), cw)
    wf = cw.packed.wfeat.double()
    want = (np.concatenate([x_lr, x_hr], 1).astype(np.float64)
            @ (wf[0] + wf[1]).numpy()[:fm.TERMS_COLS].T
            + cw.packed.cvec[2].double().numpy())
    if kf is not None:
        want = want + kf[:, None] * cw.packed.cvec[0].double().numpy()
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err < 2e-6


@pytest.mark.parametrize("ncol,z", [(3, 64), (2, 17), (1, 8)])
def test_cols_tf32x3_matches_float32_and_jax(case, ncol, z):
    """K3's composed 3xTF32 plain version against the float32 plain
    version and the JAX package's float32 Pallas kernel (interpret mode)
    and XLA twin, the same numpy-seeded inputs."""
    rng, jfw, cw = case
    x_lr, x_hr = features(rng, ncol)
    zf = np.linspace(-1.1, 0.9, z).astype(np.float32)
    j_args = (jnp.asarray(x_lr), jnp.asarray(x_hr), jnp.asarray(zf), jfw)
    want_k = jfm.fused_dual_mlp_cols(*j_args, col_block=8, interpret=True)
    want_x = jfm.fused_dual_mlp_cols_xla(*j_args)
    args = (torch.from_numpy(x_lr), torch.from_numpy(x_hr),
            torch.from_numpy(zf), cw)
    got = fm.fused_dual_mlp_cols_tf32x3_ref(*args)
    close(got, (fm.fused_dual_mlp_cols_ref(*args), want_k, want_x))


@pytest.mark.parametrize("nr", [1, 5, 17])
def test_runs_tf32x3_matches_float32_and_jax(case, nr):
    """K4's composed 3xTF32 plain version at ragged window counts against
    the float32 plain version, the Pallas kernel and the XLA twin."""
    rng, jfw, cw = case
    x_lr, x_hr = features(rng, nr)
    kf = rng.uniform(-0.8, 0.8, nr).astype(np.float32)
    zt = np.linspace(-0.2, 0.2, 8).astype(np.float32)
    j_args = [jnp.asarray(a) for a in (x_lr, x_hr, kf, zt)] + [jfw]
    want_k = jfm.fused_dual_mlp_runs(*j_args, run_block=8, interpret=True)
    want_x = jfm.fused_dual_mlp_runs_xla(*j_args)
    args = [torch.from_numpy(a) for a in (x_lr, x_hr, kf, zt)] + [cw]
    got = fm.fused_dual_mlp_runs_tf32x3_ref(*args)
    close(got, (fm.fused_dual_mlp_runs_ref(*args), want_k, want_x))


# ---------------------------------- the chain kernel's data movement ---
# threads of the two consumer warpgroups: warpgroup w, warp q, lane; the
# two rows of each (tile rows r0 and r0 + 8) and its quad index t
_T = np.arange(256)
_GID, _TIG = (_T % 32) // 4, _T % 4
_R0 = 64 * (_T // 128) + 16 * ((_T // 32) % 4) + _GID
_R1 = _R0 + 8


def _bits(v):
    """csrc/fused_cols_mlp.cu:tf32_bits, on float32 values."""
    b = np.asarray(v, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _a_matrix(regs):
    """[128 rows, 32 k] of a stage's A from the threads' fragments regs
    [256, 4 steps j, 4]: (r0, k t), (r1, k t), (r0, k t + 4), (r1, k t + 4)
    of step j, k = 8 j + t."""
    a = np.full((128, 32), np.nan)
    for j in range(4):
        k = 8 * j + _TIG
        a[_R0, k], a[_R1, k] = regs[:, j, 0], regs[:, j, 1]
        a[_R0, k + 4], a[_R1, k + 4] = regs[:, j, 2], regs[:, j, 3]
    assert not np.isnan(a).any()
    return a


def _stage_b(stage):
    """B [32 k, 128 n] of a stage's hi and lo tiles, read as the wgmma
    descriptor reads them (k8 step j: start + 32 j bytes, 1,024 between
    8-row atoms, the 128-byte swizzle)."""
    off = tile_offset(np.arange(128)[None, :], np.arange(32)[:, None])
    return stage[:4096][off], stage[4096:][off]


def _mma_stage(regs, stage):
    """d [256, 64] of one stage: lo.hi + hi.lo + hi.hi on the split
    fragments, the accumulator layout d[4 i + e] at row r0 + 8 (e // 2),
    column 8 i + 2 t + e % 2."""
    hi = _bits(regs)
    lo = _bits(regs - hi)
    bh, bl = (b.astype(np.float64) for b in _stage_b(stage))
    ah, al = _a_matrix(hi), _a_matrix(lo)
    out = al @ bh + ah @ bl + ah @ bh
    d = np.empty((256, 64))
    for i in range(16):
        for e in range(4):
            rows = _R0 + 8 * (e // 2)
            d[:, 4 * i + e] = out[rows, 8 * i + 2 * _TIG + e % 2]
    return d.astype(np.float32)


def _leaky(v):
    return np.where(v >= 0, v, np.float32(0.01) * v).astype(np.float32)


def _model_mlp(pk, terms, g0, g1, z0, z1, p0, p1, m):
    """csrc/fused_cols_mlp.cu:mlp_tf32 for one tile, numpy, per thread:
    the two rows' columns g0 / g1 in ``terms``, depths z0 / z1, coarse
    predictions p0 / p1 (None in the coarse MLP) -> (pred r0, pred r1)."""
    o = m * fm.TERMS_MLP
    wz, wp = pk.cvec[0, o:].numpy(), pk.cvec[1, o:].numpy()
    hv = pk.hvec[m].numpy()
    t0, t1 = terms[g0, o:], terms[g1, o:]
    stages = iter(pk.whid[m].numpy())
    hr = p0 is not None

    def act(acc, t, z, col, p):
        v = acc + t[_T, col] + z * wz[col]
        if hr:
            v = v + p * wp[col]
        return _leaky(v.astype(np.float32))

    def frag_cols(base, j):
        k = base + 8 * j + 2 * _TIG
        return k, k + 1

    sums = np.zeros((256, 128), np.float32)      # layer 2, [thread, v]
    for c in range(4):
        s = np.zeros((256, 64), np.float32)
        for kc in range(32):
            regs = np.empty((256, 4, 4), np.float32)
            for j in range(4):
                k, k1 = frag_cols(32 * kc, j)
                regs[:, j] = np.stack([
                    act(0, t0, z0, k, p0), act(0, t1, z1, k, p1),
                    act(0, t0, z0, k1, p0), act(0, t1, z1, k1, p1)], 1)
            s += _mma_stage(regs, next(stages))
        for i in range(16):
            n = 128 * c + 8 * i + 2 * _TIG
            for e in range(4):
                s[:, 4 * i + e] = _leaky(s[:, 4 * i + e] + hv[n + e % 2])
        for h in range(2):
            d = np.zeros((256, 64), np.float32)
            for kk in range(4):
                regs = np.stack([s[:, [4 * i, 4 * i + 2, 4 * i + 1,
                                       4 * i + 3]]
                                 for i in range(4 * kk, 4 * kk + 4)], 1)
                d = d + _mma_stage(regs, next(stages))
            sums[:, 64 * h:64 * h + 64] += d
    s = np.zeros((256, 64), np.float32)
    for kc in range(8):
        regs = np.empty((256, 4, 4), np.float32)
        for j in range(4):
            k, k1 = frag_cols(fm.TERM_LAYERS[1][1] + 32 * kc, j)
            v = 16 * kc + 4 * j
            regs[:, j] = np.stack([
                act(sums[:, v], t0, z0, k, p0),
                act(sums[:, v + 2], t1, z1, k, p1),
                act(sums[:, v + 1], t0, z0, k1, p0),
                act(sums[:, v + 3], t1, z1, k1, p1)], 1)
        s += _mma_stage(regs, next(stages))
    assert next(stages, None) is None
    l0 = np.zeros(256, np.float32)
    l1 = np.zeros(256, np.float32)
    c3 = fm.TERM_LAYERS[2][1]
    for i in range(16):
        n = 8 * i + 2 * _TIG
        for e, (t, z, p, col) in enumerate(((t0, z0, p0, n),
                                            (t0, z0, p0, n + 1),
                                            (t1, z1, p1, n),
                                            (t1, z1, p1, n + 1))):
            h = act(s[:, 4 * i + e], t, z, c3 + col, p) * hv[512 + col]
            if e < 2:
                l0 += h
            else:
                l1 += h
    # the quad's sum (shuffles), then the last layer's terms
    l0 = l0.reshape(-1, 4).sum(1).repeat(4)
    l1 = l1.reshape(-1, 4).sum(1).repeat(4)
    c4 = fm.TERM_LAYERS[3][1]
    l0 = l0 + t0[:, c4] + z0 * wz[c4]
    l1 = l1 + t1[:, c4] + z1 * wz[c4]
    if hr:
        l0, l1 = l0 + p0 * wp[c4], l1 + p1 * wp[c4]
    return 1 / (1 + np.exp(-l0)), 1 / (1 + np.exp(-l1))


def _model_tile(pk, terms, g0, g1, z0, z1):
    lr = _model_mlp(pk, terms, g0, g1, z0, z1, None, None, 0)
    hr = _model_mlp(pk, terms, g0, g1, z0, z1, lr[0], lr[1], 1)
    return hr, lr


def test_chain_model_k3_tile(case):
    """One K3 tile (128 depths of one column, 100 of them inside z) as
    the kernel moves it, against the composed plain version: the rows of
    tile_rows, store_rows' outputs."""
    rng, _, cw = case
    x_lr, x_hr = (torch.from_numpy(a) for a in features(rng, 2))
    zf = torch.linspace(-1.0, 1.0, 228)
    terms = fm.column_terms(x_lr, x_hr, None, cw).numpy()
    want = fm.fused_dual_mlp_cols_tf32x3_ref(x_lr, x_hr, zf, cw)
    col, z_tile = 1, 1                       # tile = col * 2 + 1 of 2 a col
    zb = z_tile * 128 + _R0
    z = zf.numpy()
    z0 = np.where(zb < 228, z[np.minimum(zb, 227)], 0).astype(np.float32)
    z1 = np.where(zb + 8 < 228, z[np.minimum(zb + 8, 227)], 0).astype(
        np.float32)
    g = np.full(256, col)
    hr, lr = _model_tile(cw.packed, terms, g, g, z0, z1)
    for got, ref in ((hr, want[0]), (lr, want[1])):
        out = np.full(228, np.nan)
        for v, zz in ((got[0], zb), (got[1], zb + 8)):
            ok = (_TIG == 0) & (zz < 228)
            out[zz[ok]] = v[ok]
        np.testing.assert_allclose(out[128:], ref[col, 128:].numpy(),
                                   rtol=TOL, atol=0.1 * TOL)


def test_chain_model_k4_tile(case):
    """One K4 tile (16 windows x 8 depths, the last 3 windows past n) as
    the kernel moves it, against the composed plain version."""
    rng, _, cw = case
    x_lr, x_hr = (torch.from_numpy(a) for a in features(rng, 29))
    kf = torch.from_numpy(rng.uniform(-0.8, 0.8, 29).astype(np.float32))
    zt = torch.linspace(-0.2, 0.2, 8)
    terms = torch.cat([fm.column_terms(x_lr, x_hr, kf, cw),
                       torch.zeros(3, fm.TERMS_COLS)]).numpy()
    want = fm.fused_dual_mlp_runs_tf32x3_ref(x_lr, x_hr, kf, zt, cw)
    tile = 1                                  # windows 16..31
    g0 = tile * 16 + _R0 // 8
    z = zt.numpy()[_GID]
    hr, lr = _model_tile(cw.packed, terms, g0, g0 + 1, z, z)
    for got, ref in ((hr, want[0]), (lr, want[1])):
        out = np.full((32, 8), np.nan)
        for v, g in ((got[0], g0), (got[1], g0 + 1)):
            ok = _TIG == 0
            out[g[ok], _GID[ok]] = v[ok]
        np.testing.assert_allclose(out[16:29], ref[16:29].numpy(),
                                   rtol=TOL, atol=0.1 * TOL)


# ----------------------------------------------------------- wrappers ---
@pytest.mark.parametrize("n", [1, 17, 32_768, 33_769, 262_144])
def test_float32_chunk_plan_covers_every_column_once(n):
    """The chunks of the float32 K3/K4 (as bf16's): every column once, in
    order; each chunk's kernel rows (K3: its columns; K4: its 16-window
    tiles) inside the reused column-term buffer, which the pre-pass fills
    to whole 128-row blocks."""
    plan = fm.chunk_plan(n)
    hits = np.zeros(n, np.int64)
    rows = fm._terms_buffer(plan[0][1] - plan[0][0], "meta").shape[0]
    for s, e in plan:
        assert 0 <= s < e <= n and e - s <= fm.CHUNK_COLS
        hits[s:e] += 1
        assert -(-(e - s) // 16) * 16 <= rows
        assert -(-(e - s) // fm.TERMS_BLOCK) * fm.TERMS_BLOCK <= rows
    assert (hits == 1).all()


def test_cpu_tensors_take_the_plain_versions(case):
    """CPU tensors with the float32 packing take the float32 plain
    versions and count no launch; the pre-pass alone takes its 3xTF32
    plain version."""
    rng, _, cw = case
    x_lr, x_hr = (torch.from_numpy(a) for a in features(rng, 3))
    zf, kf = torch.linspace(-1, 1, 8), torch.zeros(3)
    before = (fm.fused_dual_mlp_cols.launches,
              fm.fused_dual_mlp_runs.launches, fm.column_terms.launches)
    for got, want in (
            (fm.fused_dual_mlp_cols(x_lr, x_hr, zf, cw),
             fm.fused_dual_mlp_cols_ref(x_lr, x_hr, zf, cw.fw)),
            (fm.fused_dual_mlp_runs(x_lr, x_hr, kf, zf, cw),
             fm.fused_dual_mlp_runs_ref(x_lr, x_hr, kf, zf, cw.fw))):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(fm.column_terms(x_lr, x_hr, kf, cw),
                       fm.column_terms_ref(x_lr, x_hr, kf, cw))
    assert (fm.fused_dual_mlp_cols.launches, fm.fused_dual_mlp_runs.launches,
            fm.column_terms.launches) == before


def test_float32_kernel_calls_need_the_packing(case, monkeypatch):
    """Past the device check (here forced, as for CUDA tensors), a
    float32 call with K1's packing alone, or ColsWeights without the
    kernels' packing, raises before any launch: no plain-version
    fallback."""
    rng, _, cw = case
    monkeypatch.setattr(fm, "_check_cols_inputs", lambda *a: False)
    x_lr, x_hr = (torch.from_numpy(a) for a in features(rng, 2))
    zt, kf = torch.zeros(8), torch.zeros(2)
    for w in (cw.fw, fm.ColsWeights(cw.fw, cw.split)):
        with pytest.raises(ValueError, match="ColsWeights"):
            fm.fused_dual_mlp_cols(x_lr, x_hr, zt, w)
        with pytest.raises(ValueError, match="ColsWeights"):
            fm.fused_dual_mlp_runs(x_lr, x_hr, kf, zt, w)
    with pytest.raises(ValueError, match="ColsWeights"):
        fm.fused_dual_mlp_cols_tf32x3_ref(
            x_lr, x_hr, zt, fm.ColsWeights(cw.fw, cw.split))
