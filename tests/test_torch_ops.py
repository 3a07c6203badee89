"""The port's ops (surs_tpu_torch/ops) against the JAX package's, on the
same numpy inputs. Float32 throughout: tolerances are float32 round-off
of the few operations per value (projection, 4-tap sums, 4x4-tap
bicubic sums)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from surs_tpu.ops import geometry as jgeo
from surs_tpu.ops.grid_sample import grid_sample_points as j_grid_sample
from surs_tpu.ops.pixel_shuffle import pixel_shuffle as j_pixel_shuffle
from surs_tpu.ops.resize import avg_pool_2x as j_avg_pool
from surs_tpu.ops.resize import bicubic_upsample as j_bicubic
from surs_tpu_torch.ops import geometry as tgeo
from surs_tpu_torch.ops.grid_sample import grid_sample_points
from surs_tpu_torch.ops.pixel_shuffle import pixel_shuffle
from surs_tpu_torch.ops.resize import avg_pool_2x, bicubic_upsample

torch.set_num_threads(1)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def to_nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def test_orthogonal_and_depth(rng):
    pts = rng.standard_normal((2, 3, 50)).astype(np.float32)
    calib = np.tile(np.diag([2.0, -2.0, 2.0, 1.0]).astype(np.float32),
                    (2, 1, 1))
    calib[:, :3, 3] = rng.standard_normal((2, 3)).astype(np.float32)
    calib[:, :3, :3] += 0.1 * rng.standard_normal((2, 3, 3)).astype(
        np.float32)
    want = np.asarray(jgeo.orthogonal(jnp.asarray(pts), jnp.asarray(calib)))
    got = tgeo.orthogonal(torch.from_numpy(pts), torch.from_numpy(calib))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    z = np.array(want[:, 2:3])
    np.testing.assert_allclose(
        tgeo.normalize_depth(torch.from_numpy(z), 512, 200.0).numpy(),
        np.asarray(jgeo.normalize_depth(jnp.asarray(z), 512, 200.0)),
        rtol=1e-6)


def test_in_image_mask_bounds_inclusive():
    xy = np.array([[[-1.0, 1.0, 1.0000001, -1.0000001, 0.0],
                    [1.0, -1.0, 0.0, 0.0, 1.5]]], np.float32)
    got = tgeo.in_image_mask(torch.from_numpy(xy)).numpy()
    want = np.asarray(jgeo.in_image_mask(jnp.asarray(xy)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [[1, 1, 0, 0, 0]])


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_grid_sample_matches_jax(rng, storage):
    feat = rng.standard_normal((2, 7, 9, 5)).astype(np.float32)
    uv = rng.uniform(-1.2, 1.2, (2, 40, 2)).astype(np.float32)
    jdt = jnp.bfloat16 if storage == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if storage == "bfloat16" else torch.float32
    want = np.asarray(j_grid_sample(jnp.asarray(feat).astype(jdt),
                                    jnp.asarray(uv)), np.float32)
    got = grid_sample_points(torch.from_numpy(feat).to(tdt),
                             torch.from_numpy(uv))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_grid_sample_matches_torch_grid_sample(rng):
    feat = rng.standard_normal((1, 6, 8, 4)).astype(np.float32)
    uv = rng.uniform(-1.1, 1.1, (1, 33, 2)).astype(np.float32)
    got = grid_sample_points(torch.from_numpy(feat), torch.from_numpy(uv))
    ref = F.grid_sample(nchw(feat), torch.from_numpy(uv)[:, :, None, :],
                        mode="bilinear", padding_mode="zeros",
                        align_corners=True)[..., 0].transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)


@pytest.mark.parametrize("align_corners", [False, True])
def test_bicubic_matches_jax(rng, align_corners):
    x = rng.standard_normal((2, 5, 6, 3)).astype(np.float32)
    want = np.asarray(j_bicubic(jnp.asarray(x), 2, align_corners))
    got = to_nhwc(bicubic_upsample(nchw(x), 2, align_corners))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("align_corners", [False, True])
def test_bicubic_matches_torch_interpolate(rng, align_corners):
    x = nchw(rng.standard_normal((1, 6, 5, 2)).astype(np.float32))
    ref = F.interpolate(x, scale_factor=2, mode="bicubic",
                        align_corners=align_corners)
    np.testing.assert_allclose(bicubic_upsample(x, 2, align_corners).numpy(),
                               ref.numpy(), rtol=1e-5, atol=1e-5)


def test_pixel_shuffle_matches_jax_and_torch(rng):
    x = rng.standard_normal((2, 3, 4, 12)).astype(np.float32)
    got = pixel_shuffle(nchw(x), 2)
    np.testing.assert_array_equal(to_nhwc(got),
                                  np.asarray(j_pixel_shuffle(jnp.asarray(x),
                                                             2)))
    np.testing.assert_array_equal(got.numpy(),
                                  F.pixel_shuffle(nchw(x), 2).numpy())


def test_avg_pool_matches_jax(rng):
    x = rng.standard_normal((2, 6, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(to_nhwc(avg_pool_2x(nchw(x))),
                               np.asarray(j_avg_pool(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
