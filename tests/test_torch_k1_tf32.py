"""The float32 K1's 3xTF32 arithmetic (surs_tpu_torch/ops/fused_mlp.py:
fused_dual_mlp_tf32x3_ref, the float32 K3/K4's pre-pass and chain with one
point a row) on the CPU: against the float32 plain version and the JAX
package's float32 ``fused_dual_mlp`` (Pallas in interpret mode), in both
input forms; a numpy model of one tile of the chain kernel's point row
mode; the wrapper's dispatch and its packing. The CUDA kernels themselves
are held to the float32 plain version on the card by chip_smoke.py
(phases k1 and mono_f32).

Tolerance: the 3xTF32 chain keeps each product to about 2^-21 relative
(lo.lo dropped, each split 2^-22), so it agrees with the float32 chains to
1e-5 on outputs in [0, 1] (K1_TOL["float32"] in chip_smoke.py), here at
rtol 1e-5 / atol 1e-6 as tests/test_torch_fused_mlp.py holds the float32
plain version to the Pallas kernel."""

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
from test_torch_cols_tf32 import _R0, _TIG, _model_tile

torch.set_num_threads(1)
DIMS_LR = (321, 1024, 512, 256, 128, 1)
DIMS_HR = (322, 1024, 512, 256, 128, 1)
SPLIT = (256, 65)
TOL = 1e-5


@pytest.fixture(scope="module")
def case():
    """Flax-initialised MLPs scaled by 3 (outputs over (0, 1), as
    chip_smoke.py's kernel_mlps), carried into the port by the bridge;
    the JAX weights for each input form, and the float32 ColsWeights
    (the float32 K1's packing, built here on the CPU)."""
    p_lr = FlaxSurfaceClassifier(DIMS_LR).init(
        jax.random.PRNGKey(4), jnp.zeros((1, 4, 321)))["params"]
    p_hr = FlaxSurfaceClassifier(DIMS_HR).init(
        jax.random.PRNGKey(5), jnp.zeros((1, 4, 322)))["params"]
    p_lr, p_hr = (jax.tree_util.tree_map(lambda a: 3.0 * np.asarray(a), p)
                  for p in (p_lr, p_hr))
    t_lr = load_flax_params(SurfaceClassifier(DIMS_LR), p_lr)
    t_hr = load_flax_params(SurfaceClassifier(DIMS_HR), p_hr)
    jfw = {split: jfm.prepare_fused_weights(p_lr, p_hr, DIMS_LR, DIMS_HR,
                                            base_split=split)
           for split in (None, SPLIT)}
    cw = fm.prepare_cols_weights(t_lr, t_hr, SPLIT[0])
    return jfw, cw, (t_lr, t_hr)


def inputs(n, split, seed=0):
    """K1's input at n points: one [n, 321] part, or the served (256, 65)
    split (the depth last); numpy and torch."""
    x = np.random.default_rng(seed).standard_normal((n, 321)).astype(
        np.float32)
    if split is None:
        return x, [torch.from_numpy(x)]
    return x, [torch.from_numpy(x[:, :SPLIT[0]].copy()),
               torch.from_numpy(x[:, SPLIT[0]:].copy())]


# ------------------------------------------------- the plain versions ---
@pytest.mark.parametrize("split", [None, SPLIT])
@pytest.mark.parametrize("n", [1, 17, 129, 300])
def test_composed_plain_version_matches_float32_and_jax(case, n, split):
    """The composed 3xTF32 plain version against the float32 plain
    version and the JAX package's float32 Pallas kernel (interpret mode),
    the same numpy-seeded inputs, in either input form."""
    jfw, cw, _ = case
    x, parts = inputs(n, split, seed=n)
    jx = jnp.asarray(x) if split is None else [
        jnp.asarray(x[:, :SPLIT[0]]), jnp.asarray(x[:, SPLIT[0]:])]
    want_k = jfm.fused_dual_mlp(jx, jfw[split], block_n=256, interpret=True)
    want_p = fm.fused_dual_mlp_ref(parts, cw.fw)
    got = fm.fused_dual_mlp_tf32x3_ref(parts, cw)
    for g, wp, wk in zip(got, want_p, want_k):
        assert g.dtype == torch.float32 and tuple(g.shape) == (n,)
        np.testing.assert_allclose(g.numpy(), wp.numpy(), rtol=TOL,
                                   atol=0.1 * TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(wk), rtol=TOL,
                                   atol=0.1 * TOL)


def test_column_terms_on_strided_views(case):
    """The pre-pass's plain version on K1's parts read in place (the
    views ``_k1_split`` gives, rows 321 or 65 floats apart) equals it on
    contiguous copies; both input forms give the same views' values."""
    _, cw, _ = case
    x, one = inputs(9, None)
    _, two = inputs(9, SPLIT)
    views = fm._k1_split(one)
    assert [v.stride(0) for v in views] == [321, 321, 321]
    assert all(v.data_ptr() == one[0].data_ptr() + 4 * o
               for v, o in zip(views, (0, 320, 320)) if v.numel())
    copies = [v.contiguous() for v in views]
    got = fm.column_terms_ref(*views, cw)
    assert torch.equal(got, fm.column_terms_ref(*copies, cw))
    split_views = fm._k1_split(two)
    assert [v.stride(0) for v in split_views] == [256, 65, 65]
    for a, b in zip(split_views, (x[:, :256], x[:, 256:320], x[:, 320])):
        assert np.array_equal(a.numpy(), b)
    assert torch.equal(fm.column_terms_ref(*split_views, cw),
                       fm.column_terms_ref(x_lr=torch.from_numpy(x[:, :256]),
                                           x_hr=torch.from_numpy(
                                               x[:, 256:320].copy()),
                                           kf=torch.from_numpy(
                                               x[:, 320].copy()), cw=cw))


# ---------------------------------- the chain kernel's point row mode ---
def test_chain_model_k1_tile(case):
    """One K1 tile (points 128..255, of which 200 - 128 = 72 inside n) as
    the kernel moves it: thread rows m0 and m0 + 8 are points 128 + m0 and
    + 8 reading their own rows of the terms (the pre-pass's padding rows,
    computed from zero features and kf, past n), no in-chain depth (the
    depth is in the terms through kf), each output of a point inside n
    written once and none past n; against the composed plain version."""
    _, cw, _ = case
    n, tile = 200, 1
    x, parts = inputs(n, SPLIT, seed=3)
    views = fm._k1_split(parts)
    pad = 2 * 128 - n
    terms = torch.cat([fm.column_terms_ref(*views, cw),
                       fm.column_terms_ref(torch.zeros(pad, 256),
                                           torch.zeros(pad, 64),
                                           torch.zeros(pad), cw)]).numpy()
    want = fm.fused_dual_mlp_tf32x3_ref(parts, cw)
    g0 = tile * 128 + _R0
    zero = np.zeros(256, np.float32)
    hr, lr = _model_tile(cw.packed, terms, g0, g0 + 8, zero, zero)
    for got, ref in ((hr, want[0]), (lr, want[1])):
        out = np.full(n, np.nan)
        writes = np.zeros(2 * 128, np.int64)
        for v, g in ((got[0], g0), (got[1], g0 + 8)):
            ok = (_TIG == 0) & (g < n)
            out[g[ok]] = v[ok]
            np.add.at(writes, g[ok], 1)
        assert (writes[128:n] == 1).all() and not writes[n:].any()
        np.testing.assert_allclose(out[128:], ref[128:].numpy(), rtol=TOL,
                                   atol=0.1 * TOL)


# ----------------------------------------------------------- wrappers ---
@pytest.mark.parametrize("n", [1, 50_000, 65_536, 65_537, 200_000])
def test_k1_chunks_and_scratch(n):
    """The float32 K1's chunks: every point once, in order, each chunk's
    128-point tiles inside the one reused term buffer, whose bytes
    k1_scratch_bytes states (565 MB at the evaluators' 50,000 points, in
    one chunk)."""
    plan = fm.chunk_plan(n, fm.K1_CHUNK_POINTS)
    rows = fm._terms_buffer(plan[0][1] - plan[0][0], "meta").shape[0]
    assert fm.k1_scratch_bytes(n) == rows * fm.TERMS_COLS * 4
    hits = np.zeros(n, np.int64)
    for s, e in plan:
        assert 0 <= s < e <= n and -(-(e - s) // 128) * 128 <= rows
        hits[s:e] += 1
    assert (hits == 1).all()
    if n == 50_000:
        assert len(plan) == 1 and fm.k1_scratch_bytes(n) == 565_342_208


def test_cpu_tensors_take_the_plain_version(case, monkeypatch):
    """CPU tensors take the float32 plain version, whether or not the
    weights carry the float32 K1's packing, and count no launch."""
    _, cw, mlps = case
    _, parts = inputs(5, SPLIT)
    monkeypatch.setattr(fm, "_packs_f32_k1", lambda dev: True)
    packed = fm.prepare_fused_weights(*mlps)
    assert isinstance(packed.packed, fm.ColsPackedTF32)
    assert cw.fw.packed is None
    before = fm.fused_dual_mlp.launches
    for fw in (packed, cw.fw):
        got = fm.fused_dual_mlp(parts, fw)
        want = fm.fused_dual_mlp_ref(parts, fw)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert fm.fused_dual_mlp.launches == before


def test_float32_kernel_calls_need_the_packing(case, monkeypatch):
    """Past the device check (here forced, as for CUDA tensors), a float32
    call without the float32 K1's packing raises before any launch, and
    one with it goes to the kernels' library: no FMA kernel, no
    plain-version fallback."""
    _, cw, mlps = case
    monkeypatch.setattr(fm, "_k1_takes_plain", lambda dev: False)
    _, parts = inputs(3, SPLIT)
    bare = fm.prepare_fused_weights(*mlps)
    assert bare.packed is None
    with pytest.raises(ValueError, match="packing"):
        fm.fused_dual_mlp(parts, bare)
    with pytest.raises(ValueError, match="packing"):
        fm.fused_dual_mlp_tf32x3_ref(parts, bare)

    class Reached(Exception):
        pass

    def lib(name):
        raise Reached(name)
    monkeypatch.setattr(fm, "_kernel_lib", lib)
    with pytest.raises(Reached, match="fused_cols_mlp"):
        fm.fused_dual_mlp(parts, cw.fw._replace(packed=cw.packed))


def test_packing_is_built_once_and_shared(case, monkeypatch):
    """On the card (forced here) prepare_fused_weights packs float32
    weights at the kernel's widths once, as the float32 K3/K4's
    ColsPackedTF32, and prepare_cols_weights reuses that packing: one
    _pack_cols a service, the same buffers as the column weights'."""
    _, cw, mlps = case
    calls = []
    pack = fm._pack_cols
    monkeypatch.setattr(fm, "_pack_cols",
                        lambda fw: calls.append(1) or pack(fw))
    monkeypatch.setattr(fm, "_packs_f32_k1", lambda dev: True)
    fw = fm.prepare_fused_weights(*mlps)
    assert len(calls) == 1 and isinstance(fw.packed, fm.ColsPackedTF32)
    shared = fm.prepare_cols_weights(*mlps, SPLIT[0], fw=fw)
    assert len(calls) == 1 and shared.packed is fw.packed
    own = fm.prepare_cols_weights(*mlps, SPLIT[0])
    assert len(calls) == 2 and own.packed is own.fw.packed
    for a, b in zip(fw.packed, cw.packed):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="packed in"):
        fm.prepare_cols_weights(*mlps, SPLIT[0], dtype=torch.bfloat16,
                                fw=fw)
