"""The port's winding-number containment (surs_tpu_torch/ops/containment.py)
against the JAX package's (surs_tpu/ops/containment.py) on the CPU: the
plain version, the cut, the launch plan of the kernel, and the wrapper's
refusal to fall back from a CUDA tensor.

Tolerance: winding values agree to 1e-4 absolute (out of 4 pi = 12.6
inside). Both sum the same float32 solid angles, chunk by chunk, in
another order (XLA's reduction against torch's), about 1e-7 relative a
term on meshes of at most a few hundred triangles."""

import math

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


@pytest.mark.parametrize("n_points,n_tris,sms", [
    (25_500, 327_680, 132), (25_500, 20_480, 132), (1, 1, 132),
    (300, 12, 132), (1_000_000, 300_000, 132), (129, 257, 1),
    (25_500, 327_681, 132), (100, 10_000_000, 132)])
def test_winding_plan_covers_every_tile_once(n_points, n_tris, sms):
    """The conditions csrc/winding_number.cu checks: every tile of TILE
    triangles in exactly one of the contiguous shares, none empty, and
    grid.y within CUDA's limit."""
    splits, per = containment.winding_plan(n_points, n_tris, sms)
    tiles = -(-n_tris // containment.TILE)
    assert 1 <= splits <= 65535 and per >= 1
    assert (splits - 1) * per < tiles <= splits * per
    # the shares differ by less than a share
    assert splits * per - tiles < per
    # about BLOCKS_PER_SM blocks on each SM where the tiles allow it
    columns = -(-n_points // containment.THREADS)
    want = min(tiles, -(-sms * containment.BLOCKS_PER_SM // columns))
    assert want / 2 <= splits <= want


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
