"""The port's winding-number containment (surs_tpu_torch/ops/containment.py)
against the JAX package's (surs_tpu/ops/containment.py) on the CPU: the
plain version, the cut, the launch plan of the kernel, its triangle
records, a numpy model of its arithmetic, and the wrapper's refusal to
fall back from a CUDA tensor.

Tolerance: winding values agree to 1e-4 absolute (out of 4 pi = 12.6
inside). Both sum the same float32 solid angles, chunk by chunk, in
another order (XLA's reduction against torch's), about 1e-7 relative a
term on meshes of at most a few hundred triangles. The kernel's model
takes approximate square roots and reciprocals, each moved by a whole
ulp (their largest error), and its arctangent is within ATAN_MAX_ULP:
a few 1e-7 relative a term, within the same 1e-4."""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surs_tpu.ops import containment as jax_containment
from surs_tpu.recon.tetra import marching_tetrahedra
from surs_tpu_torch import roofline
from surs_tpu_torch.ops import containment, cuda_build

torch.set_num_threads(1)
WIND_TOL = 1e-4
# csrc/winding_number.cu's stated bound on its arctangent: ulps of the
# exact atan2 where max(|y|, |x|) lies in [2^-126, 2^126) or is 0
ATAN_MAX_ULP = 6
F32 = np.float32
FLT_MIN = np.finfo(np.float32).tiny
KERNEL_SOURCE = (Path(containment.__file__).resolve().parent.parent
                 / "csrc" / "winding_number.cu")


def cube():
    """Unit cube centred at the origin, 12 outward triangles."""
    v = np.array([[x, y, z] for x in (-.5, .5) for y in (-.5, .5)
                  for z in (-.5, .5)], np.float32)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    f = []
    for a, b, c, d in quads:
        f += [(a, b, c), (a, c, d)]
    return v, np.array(f, np.int64)


def sphere(R=12, radius=4.5):
    g = np.mgrid[:R, :R, :R].astype(np.float64) - (R - 1) / 2
    vol = (radius - np.sqrt((g ** 2).sum(0))).astype(np.float32)
    verts, faces = marching_tetrahedra(vol, 0.0)
    return ((np.asarray(verts) - (R - 1) / 2) / (2 * radius)).astype(
        np.float32), np.asarray(faces, np.int64)


def open_cube():
    v, f = cube()
    return v, f[2:]                  # one wall gone


MESHES = {"cube": cube, "sphere": sphere, "open_cube": open_cube}


def points(n=301, seed=0):
    return np.random.default_rng(seed).uniform(-0.8, 0.8, (n, 3)).astype(
        np.float32)


def jax_winding(pts, verts, faces, tri_chunk=11):
    tris = jnp.asarray(verts[faces])
    return np.asarray(jax_containment.winding_number(
        jnp.asarray(pts), tris, tri_chunk=tri_chunk))


def port_winding(pts, verts, faces):
    return containment.winding_number(
        torch.from_numpy(pts), torch.from_numpy(
            np.ascontiguousarray(verts[faces]))).numpy()


@pytest.fixture
def small_chunks(monkeypatch):
    """Chunks that the point and triangle counts are no multiples of."""
    monkeypatch.setattr(containment, "REF_POINT_CHUNK", 64)
    monkeypatch.setattr(containment, "REF_TRI_CHUNK", 7)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_winding_ref_matches_jax(mesh, small_chunks):
    verts, faces = MESHES[mesh]()
    assert faces.shape[0] % 7 and faces.shape[0] % 11
    pts = points()
    want = jax_winding(pts, verts, faces)
    got = port_winding(pts, verts, faces)
    assert got.dtype == np.float32 and got.shape == (301,)
    np.testing.assert_allclose(got, want, rtol=0, atol=WIND_TOL)


@pytest.mark.parametrize("mesh", ["cube", "sphere"])
def test_contains_matches_jax_exactly(mesh, small_chunks):
    verts, faces = MESHES[mesh]()
    pts = points(1000, seed=1)
    want = np.asarray(jax_containment.contains(pts, verts, faces))
    got = containment.contains(pts, verts, faces, device="cpu")
    assert got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)
    if mesh == "cube":
        np.testing.assert_array_equal(got, (np.abs(pts) < 0.5).all(1))


def test_contains_open_mesh_outside_the_band():
    """An open mesh puts some points near |w| = pi: there the two
    summation orders may cut differently; everywhere else the labels
    are equal."""
    verts, faces = open_cube()
    pts = points(1000, seed=2)
    w = jax_winding(pts, verts, faces, tri_chunk=2048)
    want = np.asarray(jax_containment.contains(pts, verts, faces))
    got = containment.contains(pts, verts, faces, device="cpu")
    clear = np.abs(np.abs(w) - math.pi) > WIND_TOL
    assert clear.sum() > 900
    np.testing.assert_array_equal(got[clear], want[clear])
    # the deep interior behind the opening still counts as inside
    c = containment.contains(np.array([[0.0, 0.0, 0.0], [2.0, 0.0, 0.0]]),
                             verts, faces, device="cpu")
    assert c.tolist() == [True, False]


def test_zero_area_triangles_and_a_point_on_a_vertex():
    """Zero-area triangles (the JAX package's padding) add exactly
    nothing; a point on a vertex gets atan2(+-0, +0) = 0 from the
    triangles there, not pi, and agrees with the JAX package."""
    verts, faces = cube()
    tris = verts[faces]
    degenerate = np.stack([tris[:3, 0]] * 3, axis=1)       # A, A, A
    sliver = tris[:2].copy()
    sliver[:, 2] = sliver[:, 1]                            # A, B, B
    padded = np.concatenate([tris, degenerate, sliver, np.zeros_like(
        tris[:1])])
    pts = np.concatenate([points(50, seed=3), verts[:2],
                          np.zeros((1, 3), np.float32)])
    base = containment.winding_number_ref(torch.from_numpy(pts),
                                          torch.from_numpy(tris)).numpy()
    more = containment.winding_number_ref(
        torch.from_numpy(pts), torch.from_numpy(padded)).numpy()
    np.testing.assert_allclose(more, base, rtol=0, atol=1e-6)
    want = np.asarray(jax_containment.winding_number(
        jnp.asarray(pts), jnp.asarray(tris), tri_chunk=16))
    np.testing.assert_allclose(base, want, rtol=0, atol=WIND_TOL)
    # a corner sees the cube's inside as an eighth of the sphere
    np.testing.assert_allclose(base[50:52], 4 * math.pi / 8, atol=1e-5)
    zero = containment.winding_number_ref(
        torch.zeros((1, 3)), torch.zeros((1, 3, 3))).numpy()
    assert zero.tolist() == [0.0]


@pytest.mark.parametrize("n_points,n_tris,sms,blocks_per_sm", [
    (25_500, 327_680, 132, 4), (25_500, 20_480, 132, 4), (1, 1, 132, 4),
    (300, 12, 132, 4), (1_000_000, 300_000, 132, 4), (129, 257, 1, 1),
    (25_500, 327_681, 132, 5), (100, 10_000_000, 132, 4),
    (65_536, 327_680, 132, 6), (6_000, 20_480, 132, 4)])
def test_winding_plan_covers_every_tile_once(n_points, n_tris, sms,
                                             blocks_per_sm):
    """The conditions csrc/winding_number.cu checks: every tile of TILE
    triangles in exactly one of the contiguous shares, none empty, and
    grid.y within CUDA's limit; the blocks within MAX_WAVES waves of the
    resident ones, and the waves at least 90 % full of work where the
    tiles can be split finer."""
    splits, per = containment.winding_plan(n_points, n_tris, sms,
                                           blocks_per_sm)
    tiles = -(-n_tris // containment.TILE)
    assert 1 <= splits <= 65535 and per >= 1
    assert (splits - 1) * per < tiles <= splits * per
    # the shares differ by less than a share
    assert splits * per - tiles < per
    columns = -(-n_points // containment.BLOCK_POINTS)
    slots = sms * blocks_per_sm
    assert splits == 1 or columns * splits <= containment.MAX_WAVES * slots
    waves = -(-columns * splits // slots)
    assert per == 1 or columns * tiles >= 0.9 * waves * slots * per


def test_kernel_constants_match_the_source():
    """The wrapper's copies of the kernel's block shape and arctangent
    coefficients are the ones csrc/winding_number.cu compiles."""
    src = KERNEL_SOURCE.read_text()

    def const(name):
        m = re.search(rf"constexpr (?:int|float) {name} = ([^;]+?)f?;", src)
        return m.group(1)
    assert int(const("THREADS")) == containment.THREADS
    assert int(const("POINTS_PER_THREAD")) == containment.POINTS_PER_THREAD
    assert int(const("TILE")) == containment.TILE
    assert int(const("RECORD_BYTES")) == 4 * containment.RECORD_FLOATS
    coeffs = [F32(const(f"ATAN_C{k}"))
              for k in range(len(containment.ATAN_COEFFS))]
    assert coeffs == [F32(c) for c in containment.ATAN_COEFFS]
    assert f"ATAN_C{len(coeffs)}" not in src


def test_pack_triangles_record_layout():
    """A triangle is 12 floats, 48 bytes: A, B, C, each padded with a 0,
    so that record k starts 48 k bytes in (16-byte aligned)."""
    tris = torch.from_numpy(np.random.default_rng(7).normal(
        size=(5, 3, 3)).astype(np.float32))
    rec = containment.pack_triangles(tris)
    assert rec.shape == (5, 3, 4) and rec.dtype == torch.float32
    assert rec.is_contiguous() and rec.stride(0) == 12
    flat = rec.reshape(-1).numpy()
    for k in range(5):
        want = np.concatenate([np.append(tris[k, v].numpy(), 0.0)
                               for v in range(3)])
        np.testing.assert_array_equal(flat[12 * k:12 * k + 12], want)
    assert not (flat.view(np.uint32)[3::4]).any()      # +0.0 padding


# --------------------------------------------- the kernel's arithmetic ---
def _fma32(a, b, c):
    """a * b + c rounded once to float32 (the product of two float32
    values is exact in float64)."""
    return (np.asarray(a, np.float64) * b + c).astype(np.float32)


def _nudge(r, ulps):
    """r moved by ``ulps`` whole ulps (an approximate MUFU result)."""
    return (r + F32(ulps) * np.spacing(r)).astype(np.float32)


def rcp_approx(x, ulps=0):
    """rcp.approx.ftz.f32: 1 / x off by up to an ulp, a subnormal result
    flushed to 0 (x here is at least FLT_MIN)."""
    with np.errstate(divide="ignore"):
        r = _nudge((F32(1) / x).astype(np.float32), ulps)
    return np.where(r < FLT_MIN, F32(0), r)


def sqrt_approx(x, ulps=0):
    """sqrt.approx.ftz.f32: a subnormal input flushed to 0, the root off
    by up to an ulp."""
    x = np.where(x < FLT_MIN, F32(0), x)
    r = np.sqrt(x).astype(np.float32)
    return np.where(r > 0, _nudge(r, ulps), r)


def atan2_approx(y, x, rcp_ulps=0):
    """The kernel's atan2_approx in numpy float32: r = min / max of |y|,
    |x| (the max held at FLT_MIN or more), atan(r) = r P(r^2) by Horner's
    fused multiply-adds, pi/2 - t where |y| > |x|, pi - t where x's sign
    bit is set, and y's sign."""
    y, x = np.asarray(y, np.float32), np.asarray(x, np.float32)
    ax, ay = np.abs(x), np.abs(y)
    mn = np.minimum(ax, ay)
    mx = np.maximum(np.maximum(ax, ay), FLT_MIN)
    r = (mn * rcp_approx(mx, rcp_ulps)).astype(np.float32)
    s = (r * r).astype(np.float32)
    c = [F32(v) for v in containment.ATAN_COEFFS]
    p = np.full_like(s, c[-1])
    for ck in c[-2::-1]:
        p = _fma32(p, s, ck)
    t = (r * p).astype(np.float32)
    t = np.where(ay > ax, F32(math.pi / 2) - t, t)
    t = np.where(np.signbit(x), F32(math.pi) - t, t)
    return np.copysign(t, y).astype(np.float32)


def atan2_grid():
    """(y, x) float32: every pair of signed zeros, FLT_MIN, tiny, unit
    and huge values up to 2^125 (extreme ratios, every sign of both, a
    negative denominator among them); the unit circle in 1e5 steps; 2e5
    random pairs with magnitudes from 1e-17 to 1e17."""
    mags = [0.0, float(FLT_MIN), 1e-30, 1e-7, 0.3, 1.0, 1.7, 1e7, 1e30,
            2.0 ** 125]
    vals = np.array(sorted({v * sg for v in mags for sg in (1.0, -1.0)}
                           | {-0.0}), np.float32)
    gy, gx = np.meshgrid(vals, vals, indexing="ij")
    ang = np.linspace(-math.pi, math.pi, 100_001)
    rng = np.random.default_rng(8)
    ry, rx = (rng.standard_normal(200_000) * np.exp(
        rng.uniform(-40, 40, 200_000)) for _ in range(2))
    y = np.concatenate([gy.ravel(), np.sin(ang), ry]).astype(np.float32)
    x = np.concatenate([gx.ravel(), np.cos(ang), rx]).astype(np.float32)
    return y, x


@pytest.mark.parametrize("rcp_ulps", [-1, 0, 1])
def test_kernel_atan2_within_its_ulp(rcp_ulps):
    """The kernel's arctangent (its numpy model, the reciprocal off by an
    ulp either way) within ATAN_MAX_ULP of the exact atan2 over the grid;
    signed zeros exactly IEEE's: atan2(+-0, +0) = +-0 (a point on a
    vertex), atan2(+-0, -0) = +-pi, and pi where the denominator is
    negative and det is +0."""
    y, x = atan2_grid()
    got = atan2_approx(y, x, rcp_ulps)
    want = np.arctan2(y.astype(np.float64), x.astype(np.float64))
    ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    err = np.abs(got.astype(np.float64) - want) / ulp
    assert err.max() <= ATAN_MAX_ULP, (err.max(), y[err.argmax()],
                                       x[err.argmax()])
    zeros = (y == 0) & (x == 0)
    np.testing.assert_array_equal(np.signbit(got[zeros]),
                                  np.signbit(y[zeros]))
    np.testing.assert_array_equal(np.abs(got[zeros]),
                                  np.where(np.signbit(x[zeros]),
                                           F32(math.pi), F32(0)))
    neg = (y == 0) & ~np.signbit(y) & (x < 0)
    assert neg.any() and (got[neg] == F32(math.pi)).all()


def kernel_model(pts, tris, ulps):
    """The winding number as the kernel computes a pair, in numpy
    float32: differences first, approximate square roots, atan2_approx,
    the halves summed and doubled; every approximate result moved by
    ``ulps`` (the compiler's fused multiply-adds are not modeled: they
    change roundings only)."""
    a, b, c = (tris[None, :, k, :] - pts[:, None, :] for k in range(3))
    la, lb, lc = (sqrt_approx((v * v).sum(-1, dtype=np.float32), ulps)
                  for v in (a, b, c))
    det = (a * np.cross(b, c)).sum(-1, dtype=np.float32)
    denom = la * lb * lc
    denom = denom + (a * b).sum(-1, dtype=np.float32) * lc
    denom = denom + (b * c).sum(-1, dtype=np.float32) * la
    denom = denom + (c * a).sum(-1, dtype=np.float32) * lb
    return F32(2) * atan2_approx(det, denom, ulps).sum(-1, dtype=np.float32)


def padded_cube():
    """The cube's triangles, zero-area ones (A, A, A and A, B, B) and an
    all-zero one, with points on its vertices and at its centre."""
    verts, faces = cube()
    tris = verts[faces]
    degenerate = np.stack([tris[:3, 0]] * 3, axis=1)
    sliver = tris[:2].copy()
    sliver[:, 2] = sliver[:, 1]
    tris = np.concatenate([tris, degenerate, sliver,
                           np.zeros_like(tris[:1])])
    pts = np.concatenate([points(50, seed=3), verts,
                          np.zeros((1, 3), np.float32)])
    return pts, tris


@pytest.mark.parametrize("ulps", [-1, 1])
@pytest.mark.parametrize("mesh", ["cube", "sphere", "open_cube",
                                  "padded_cube"])
def test_kernel_arithmetic_matches_the_plain_version(mesh, ulps):
    """The kernel's pair arithmetic (its numpy model) against the plain
    version within WIND_TOL; points on a vertex take 0 from the
    triangles there (a corner sees the cube's inside as an eighth of
    the sphere), zero-area triangles add nothing."""
    if mesh == "padded_cube":
        pts, tris = padded_cube()
    else:
        verts, faces = MESHES[mesh]()
        pts, tris = points(), verts[faces]
    got = kernel_model(pts, tris, ulps)
    want = containment.winding_number_ref(
        torch.from_numpy(pts), torch.from_numpy(tris)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=WIND_TOL)
    if mesh == "padded_cube":
        np.testing.assert_allclose(got[50:58], 4 * math.pi / 8, atol=1e-5)
        np.testing.assert_allclose(got[58], 4 * math.pi, atol=1e-5)


# two functions of cuobjdump -sass text: the winding kernel, whose loop
# (0x10-0xa0) holds an IEEE-style square root with a branch over its
# slow-path call, and the reduce kernel's loop without MUFU
SASS = """
\tFunction : _ZN12_GLOBAL__N_121winding_number_kernelEPKfPK6float4Pfiii
        /*0000*/                   MOV R1, c[0x0][0x28] ;   /* 0x0 */
        /*0010*/                   LDS R2, [UR4] ;          /* 0x0 */
        /*0020*/                   MUFU.RSQ R3, R2 ;        /* 0x0 */
        /*0030*/              @!P0 BRA 0x60 ;               /* 0x0 */
        /*0040*/                   CALL.REL.NOINC 0x200 ;   /* 0x0 */
        /*0050*/                   BRA 0x70 ;               /* 0x0 */
        /*0060*/                   FMUL R4, R2, R3 ;        /* 0x0 */
        /*0070*/                   MUFU.SQRT R5, R2 ;       /* 0x0 */
        /*0080*/                   MUFU.RSQ R6, R2 ;        /* 0x0 */
        /*0090*/                   NOP ;                    /* 0x0 */
        /*00a0*/               @P1 BRA 0x10 ;               /* 0x0 */
        /*00b0*/                   EXIT ;                   /* 0x0 */
\tFunction : _ZN12_GLOBAL__N_128winding_number_reduce_kernelEPKfPfii
        /*0000*/                   FADD R1, R1, R2 ;        /* 0x0 */
        /*0010*/               @P0 BRA 0x0 ;                /* 0x0 */
"""


def test_sass_loop_counts_the_common_path():
    """probes/winding_sass.py: the winding kernel's loop, NOPs left out,
    the branch over the slow-path call taken: 7 instructions issued for
    one pair (three square roots)."""
    from surs_tpu_torch.probes import winding_sass
    loop = winding_sass.sass_loop(SASS)
    assert loop["body_instructions"] == 9
    assert loop["path_instructions"] == 7
    assert loop["pairs_per_iteration"] == 1 and loop["per_pair"] == 7.0
    assert loop["mufu"] == {"MUFU.RSQ": 2, "MUFU.SQRT": 1}
    assert len(loop["listing"]) == 9
    assert "error" in winding_sass.sass_loop(SASS, "winding_number_"
                                                   "reduce_kernel")
    # 32 pairs a warp instruction, 4 a clock on each of 132 SMs at 1 GHz
    assert winding_sass.issue_ms(1.0, 32 * 4 * 132 * 1e6, 132, 1000.0) \
        == pytest.approx(1.0)


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch, tmp_path):
    """A CUDA tensor builds and launches the kernel or raises; a failed
    build raises and the plain version is not called."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    def plain(*a):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(cuda_build, "_LOADED", {})
    monkeypatch.setattr(cuda_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(containment, "winding_number_ref", plain)
    pts = torch.Tensor._make_subclass(_FakeCuda, torch.zeros((4, 3)))
    tris = torch.Tensor._make_subclass(_FakeCuda, torch.zeros((2, 3, 3)))
    assert pts.device.type == "cuda"
    before = containment.winding_number.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        containment.winding_number(pts, tris)
    assert containment.winding_number.launches == before


def test_wrapper_checks_its_inputs():
    good = torch.zeros((4, 3))
    tris = torch.zeros((2, 3, 3))
    with pytest.raises(ValueError, match="points"):
        containment.winding_number(torch.zeros((4, 2)), tris)
    with pytest.raises(ValueError, match="tris"):
        containment.winding_number(good, torch.zeros((2, 9)))
    with pytest.raises(ValueError, match="float32"):
        containment.winding_number(good.double(), tris)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        containment.winding_number(good.to("meta"), tris.to("meta"))


def test_contains_without_a_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    verts, faces = cube()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        containment.contains(points(3), verts, faces)


def test_containment_work():
    ops, nbytes = roofline.containment_work(25_500, 327_680)
    assert roofline.CONTAINMENT_PAIR_OPS == 67
    assert ops == 67.0 * 25_500 * 327_680
    assert nbytes == 25_500 * 16 + 327_680 * 36
    ms, by = roofline.bound(ops, nbytes, "float32")
    assert by == "operations" and ms == pytest.approx(8.35584)
    assert roofline.CONTAINMENT_POINTS == 25_500
