"""Kernel K2's 3xTF32 arithmetic (surs_tpu_torch/ops/fused_mlp.py:
tf32_split, the tile layout, pack_k2, the plain versions of the GEMM and
head kernels, composed in fused_dual_mlp_train_tf32x3_ref) against the JAX
package on the CPU: the Pallas kernel in interpret mode and the XLA twin.
The CUDA kernels themselves are held to these plain versions on the card
by chip_smoke.py (phase k2).

Tolerances: the split is bit-exact (integer arithmetic on both sides).
hi + lo recovers a float32 value to 2^-22 relative; 2^-21 is held. The
composed forward keeps every product to about 2^-21 relative (the lo.lo
term dropped, each split 2^-22), at float32 FMA's level, so it agrees
with the float32 JAX kernel to rtol 1e-5, atol 1e-6, as the plain K2
does (tests/test_torch_fused_train.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surs_tpu.ops import fused_mlp as jfm
from surs_tpu_torch.compat.flax_import import load_flax_params
from surs_tpu_torch.models.surface_classifier import SurfaceClassifier
from surs_tpu_torch.ops import fused_mlp as fm

torch.set_num_threads(1)
DIMS_LR = (321, 1024, 512, 256, 128, 1)
DIMS_HR = (322, 1024, 512, 256, 128, 1)
N_MAX = 130


def mlp_params(dims, rng, scale):
    """Flax-layout params of a SurfaceClassifier (res layers 2, 3, 4)."""
    out = {}
    for i in range(len(dims) - 1):
        d_in = dims[i] + (dims[0] if i in (2, 3, 4) else 0)
        out[f"conv{i}"] = {
            "kernel": (scale / np.sqrt(d_in) * rng.standard_normal(
                (d_in, dims[i + 1]))).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(dims[i + 1])).astype(
                np.float32)}
    return out


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(11)
    # weights large enough that the outputs spread over (0, 1)
    p_lr = mlp_params(DIMS_LR, rng, 2.0)
    p_hr = mlp_params(DIMS_HR, rng, 2.0)
    xa = rng.standard_normal((N_MAX, 321)).astype(np.float32)
    xb = rng.standard_normal((N_MAX, 321)).astype(np.float32)
    mask = (rng.random(N_MAX) > 0.3).astype(np.float32)
    fw = fm.prepare_fused_weights(
        load_flax_params(SurfaceClassifier(DIMS_LR), p_lr),
        load_flax_params(SurfaceClassifier(DIMS_HR), p_hr))
    jw = jfm.prepare_fused_weights(p_lr, p_hr, DIMS_LR, DIMS_HR)
    return xa, xb, mask, fw, jw


def rna_numpy(v):
    """cvt.rna.tf32.f32 on the bits, in numpy's uint32 arithmetic."""
    bits = v.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def test_tf32_split_is_bit_exact():
    rng = np.random.default_rng(0)
    v = (rng.standard_normal(4096) * np.exp2(rng.integers(-60, 60, 4096))
         ).astype(np.float32)
    # exact ties of the rounding (low 13 bits 0x1000), both signs, zeros
    # and subnormals
    ties = (v.view(np.uint32) & np.uint32(0xFFFFE000)) | np.uint32(0x1000)
    v = np.concatenate([v, ties.view(np.float32), np.float32([
        0.0, -0.0, 1e-40, -1e-40, 1.0, -1.0, 3.0e38])])
    hi, lo = fm.tf32_split(torch.from_numpy(v))
    hi, lo = hi.numpy(), lo.numpy()
    want_hi = rna_numpy(v)
    np.testing.assert_array_equal(hi.view(np.uint32), want_hi.view(np.uint32))
    np.testing.assert_array_equal(
        lo.view(np.uint32), rna_numpy(v - want_hi).view(np.uint32))
    assert not (hi.view(np.uint32) & np.uint32(0x1FFF)).any()
    assert not (lo.view(np.uint32) & np.uint32(0x1FFF)).any()
    err = np.abs(v.astype(np.float64) - hi.astype(np.float64)
                 - lo.astype(np.float64))
    # where lo is a normal float32 (subnormals keep fewer bits)
    big = np.abs(v) > 1e-30
    assert big.sum() > 8000
    assert (err[big] <= 2.0 ** -21 * np.abs(v[big].astype(np.float64))).all()
    # ties round away from zero
    t = ties.view(np.float32)[:8]
    assert (np.abs(rna_numpy(t)) > np.abs(t)).all()


def test_tile_layout_is_the_swizzled_k_major_layout():
    rows, cols = 256, 96
    idx = fm.tile_index(rows, cols).numpy()
    assert sorted(idx) == list(range(rows * cols))
    pos = np.empty(rows * cols, np.int64)
    pos[idx] = np.arange(rows * cols)
    m, k = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    want = (((m // 128) * (cols // 32) + k // 32) * 4096 + (m % 128) * 32
            + (((k % 32) // 4) ^ (m % 8)) * 4 + k % 4)
    np.testing.assert_array_equal(pos.reshape(rows, cols), want)
    v = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (rows, cols)).astype(np.float32))
    hi, lo = fm.unsplit_tiles(fm.split_tiles(v), rows, cols)
    want_hi, want_lo = fm.tf32_split(v)
    assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)


def jax_layer(jw, mlp: int, i: int):
    """Layer i of JAX's padded float32 weights as K2's W [N, K]: the h
    rows, then the input's 321 rows (and, for the fine MLP, the coarse
    prediction's row) from their 128-aligned segments, zero-padded to
    K2_XK; and its bias."""
    spec = (jw.spec_lr, jw.spec_hr)[mlp]
    W = np.asarray((jw.lr_w, jw.hr_w)[mlp][i])
    n = spec.dims[i + 1]
    blocks, off = [], 0
    if i > 0:
        blocks.append(W[:spec.dims[i], :n])
        off = spec.dims[i]
    if i == 0 or i in spec.res_layers:
        x = np.zeros((fm.K2_XK, n), np.float32)
        for j, real in enumerate(spec.base_segments):
            x[j * 321:j * 321 + real] = W[off:off + real, :n]
            off += -(-real // 128) * 128
        blocks.append(x)
    b = np.asarray((jw.lr_b, jw.hr_b)[mlp][i])[0, :n]
    return np.concatenate(blocks).T, b


def test_k2_weight_tiles_unpack_to_jax_weights(case):
    *_, fw, jw = case
    before = fm.pack_k2.launches
    wt = fm.pack_k2(fw)                 # the CPU takes pack_k2_ref
    assert fm.pack_k2.launches == before
    assert tuple(wt.shape) == (2, fm.K2_WBUF)
    for mlp in range(2):
        off = 0
        for i, (n, k) in enumerate(fm.K2_LAYERS):
            tiles = wt[mlp, off:off + 2 * n * k].view(2, -1)
            off += 2 * n * k
            hi, lo = fm.unsplit_tiles(tiles, n, k)
            W, _ = jax_layer(jw, mlp, i)
            want_hi, want_lo = fm.tf32_split(torch.from_numpy(W))
            assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
            np.testing.assert_allclose((hi + lo).numpy(), W, rtol=2.0 ** -21,
                                       atol=0)
        assert off == fm.K2_WBUF


@pytest.mark.parametrize("n", [1, 127, 129])
def test_k2_tf32x3_arithmetic_matches_jax(case, n):
    xa, xb, mask, fw, jw = (case[0][:n], case[1][:n], case[2][:n], case[3],
                            case[4])
    args = (jnp.asarray(xa), jnp.asarray(xb), jnp.asarray(mask))
    twin = jfm.fused_dual_mlp_train_xla(*args, jw)
    pallas = jfm.fused_dual_mlp_train(*args, jw, block_n=128, interpret=True)
    got = fm.fused_dual_mlp_train_tf32x3_ref(
        torch.from_numpy(xa), torch.from_numpy(xb), torch.from_numpy(mask),
        fw)
    for want in (twin, pallas):
        for g, w in zip(got, want):
            assert tuple(g.shape) == (n,)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-6)


def test_k2_tf32x3_spreads_and_uses_the_mask(case):
    xa, xb, mask, fw, _ = case
    t = [torch.from_numpy(a) for a in (xa, xb)]
    hr1, lr1 = fm.fused_dual_mlp_train_tf32x3_ref(*t, torch.from_numpy(mask),
                                                  fw)
    hr0, lr0 = fm.fused_dual_mlp_train_tf32x3_ref(*t, torch.ones(N_MAX), fw)
    assert lr1.min() < 0.2 and lr1.max() > 0.8      # a spread, unmasked
    assert hr1.min() < 0.2 and hr1.max() > 0.8
    assert torch.equal(lr1, lr0)
    on = torch.from_numpy(mask) > 0
    assert torch.equal(hr1[on], hr0[on]) and (hr1[~on] != hr0[~on]).all()


def test_tf32x3_linear_on_the_cpu_takes_the_plain_version():
    rng = np.random.default_rng(2)
    rows, n_out = 256, 128
    a = torch.from_numpy(rng.standard_normal((rows, 96)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((n_out, 96)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(n_out).astype(np.float32))
    before = fm.tf32x3_linear.launches
    out = fm.tf32x3_linear(fm.split_tiles(a[:, :64]),
                           fm.split_tiles(a[:, 64:]), fm.split_tiles(w), b,
                           rows)
    assert fm.tf32x3_linear.launches == before
    hi, lo = fm.unsplit_tiles(out, rows, n_out)
    want = fm.tf32x3_linear_ref(*fm.tf32_split(a), *fm.tf32_split(w), b)
    assert torch.equal(torch.stack([hi, lo]),
                       torch.stack(fm.tf32_split(want)))
    full = a @ w.t() + b
    full = torch.where(full >= 0, full, 0.01 * full)
    torch.testing.assert_close(hi + lo, full, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="tf32x3_linear"):
        fm.tf32x3_linear(fm.split_tiles(a[:, :64]), None, fm.split_tiles(w),
                         b, rows)


def test_k2_scratch_covers_the_kernel_buffers():
    # xa, xb at K2_XK and layers 0-3's outputs, hi and lo, 128-row tiles
    assert fm.k2_scratch_floats(12_000) == 12_032 * 2 * (
        2 * 352 + 1024 + 512 + 256 + 128)
    assert fm.k2_scratch_floats(128) == 128 * 2 * 2624
