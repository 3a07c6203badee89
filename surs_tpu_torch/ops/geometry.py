"""Projection and depth-normalization primitives
(counterpart of ``surs_tpu/ops/geometry.py``).

Points are ``[B, 3, N]`` world coordinates; image-space uv is in
[-1, 1] with y already flipped by the calibration matrix. The projection
stays in float32 whatever the trunk's dtype: it feeds the uv coordinates
whose accuracy gates the feature gathers.
"""

from __future__ import annotations

import torch


def _image_transform(xy: torch.Tensor, transforms) -> torch.Tensor:
    """xy [B, 2, N] through an optional [B, 2, 3] image-space affine."""
    if transforms is None:
        return xy
    transforms = transforms.float()
    return torch.bmm(transforms[:, :2, :2], xy) + transforms[:, :2, 2:3]


def orthogonal(points: torch.Tensor, calibs: torch.Tensor,
               transforms=None) -> torch.Tensor:
    """Orthographic projection: points [B, 3, N], calibs [B, 3|4, 4] ->
    [B, 3, N]: (u, v) in [-1, 1] and z in camera units; ``transforms``
    ([B, 2, 3]) optionally maps (u, v) once more."""
    calibs = calibs.float()
    pts = torch.bmm(calibs[:, :3, :3], points.float()) + calibs[:, :3, 3:4]
    if transforms is None:
        return pts
    return torch.cat([_image_transform(pts[:, :2], transforms),
                      pts[:, 2:3]], dim=1)


def perspective(points: torch.Tensor, calibs: torch.Tensor,
                transforms=None) -> torch.Tensor:
    """Perspective projection, :func:`orthogonal`'s signature: x and y
    divided by the depth (``surs_tpu/ops/geometry.py:perspective``)."""
    calibs = calibs.float()
    homo = torch.bmm(calibs[:, :3, :3], points.float()) + calibs[:, :3, 3:4]
    xy = _image_transform(homo[:, :2] / homo[:, 2:3], transforms)
    return torch.cat([xy, homo[:, 2:3]], dim=1)


PROJECTIONS = {"orthogonal": orthogonal, "perspective": perspective}


def normalize_depth(z: torch.Tensor, load_size: int,
                    z_size: float) -> torch.Tensor:
    """Depth feature ``z * (load_size // 2) / z_size``."""
    return z * float(load_size // 2) / float(z_size)


def in_image_mask(xy: torch.Tensor) -> torch.Tensor:
    """xy [..., 2, N] -> float mask [..., N]: 1 where both coordinates lie
    in [-1, 1], bounds inclusive."""
    u = xy[..., 0, :]
    v = xy[..., 1, :]
    inside = (u >= -1.0) & (u <= 1.0) & (v >= -1.0) & (v <= 1.0)
    return inside.to(xy.dtype)
