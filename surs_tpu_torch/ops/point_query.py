"""Fused point query: projection, in-image mask, feature gathers, depth
feature and kernel K1 (counterpart of ``fused_query`` in
``surs_tpu/ops/point_query.py``).

The sampled lr features and the [hr features | depth] block enter K1 as
two separate float32 parts (the (256, 65) split), so no [N, 321]
concatenation is built; the in-image mask multiplies both outputs after
the sigmoid.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .fused_mlp import FusedWeights, fused_dual_mlp
from .geometry import in_image_mask, normalize_depth, orthogonal
from .grid_sample import grid_sample_points


def fused_query(fw: FusedWeights, feat_lr: torch.Tensor,
                feat_hr: torch.Tensor, points: torch.Tensor,
                calibs: torch.Tensor, load_size: int, z_size: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """points [B, 3, N] -> (pred_hr [B, N], pred_lr [B, N])."""
    xyz = orthogonal(points, calibs)
    xy = xyz[:, :2, :]
    mask = in_image_mask(xy)                                   # [B, N]
    z_feat = normalize_depth(xyz[:, 2:3, :], load_size,
                             z_size).transpose(1, 2)           # [B, N, 1]
    uv = xy.transpose(1, 2)                                    # [B, N, 2]
    x_lr = grid_sample_points(feat_lr, uv)
    xz = torch.cat([grid_sample_points(feat_hr, uv), z_feat], dim=-1)
    B, N, _ = x_lr.shape
    hr, lr = fused_dual_mlp([x_lr.reshape(B * N, -1),
                             xz.reshape(B * N, -1)], fw)
    return hr.view(B, N) * mask, lr.view(B, N) * mask

