"""SuRSNet inference (counterpart of ``surs_tpu/models/surs_net.py``):

  encode(images_lr)                 -> (img_sr, [feat_lr], feat_hr)
  query(feats, feat_hr, pts, calib) -> (pred_hr [B, N], pred_lr [B, N])

``query`` is the plain reference chain through the two
SurfaceClassifiers in float32; the serving path scores points with
kernel K1 instead (ops/point_query.py). The training forward and its
loss are not ported yet (ROADMAP.md A9).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn

from ..ops.geometry import in_image_mask, normalize_depth, orthogonal
from ..ops.grid_sample import grid_sample_points
from .hourglass import HGFilter
from .layers import init_weights
from .sr_net import SuRSSR
from .surface_classifier import SurfaceClassifier

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class SuRSNet(nn.Module):
    def __init__(self, num_stack_lr: int = 3, num_stack_hr: int = 1,
                 hg_depth: int = 2, hg_dim: int = 256, norm: str = "group",
                 mlp_dim_lr: Sequence[int] = (321, 1024, 512, 256, 128, 1),
                 mlp_dim_hr: Sequence[int] = (322, 1024, 512, 256, 128, 1),
                 mlp_res_layers_lr: Sequence[int] = (2, 3, 4),
                 mlp_res_layers_hr: Sequence[int] = (2, 3, 4),
                 no_residual: bool = False, n_block=(2, 2, 2),
                 residual: bool = False, scale: int = 2,
                 load_size: int = 512, z_size: float = 200.0):
        super().__init__()
        self.load_size = load_size
        self.z_size = z_size
        self.super_resolution = SuRSSR(n_block, residual, scale)
        self.image_filter_lr = HGFilter(num_stack_lr, hg_depth, 256, hg_dim,
                                        norm, "low_res")
        self.image_filter_hr = HGFilter(num_stack_hr, hg_depth, 64, 64,
                                        norm, "high_res")
        self.mlp_lr = SurfaceClassifier(mlp_dim_lr, mlp_res_layers_lr,
                                        no_residual)
        self.mlp_hr = SurfaceClassifier(mlp_dim_hr, mlp_res_layers_hr,
                                        no_residual)

    def set_trunk_dtype(self, dtype: torch.dtype) -> "SuRSNet":
        """Run the conv trunk (SuRSSR and both HGFilters) in ``dtype``;
        the point MLPs stay float32."""
        for m in (self.super_resolution, self.image_filter_lr,
                  self.image_filter_hr):
            m.to(dtype)
        return self

    def encode(self, images_lr: torch.Tensor):
        """images_lr [B, S, S, 3] -> (img_sr, [feat_lr], feat_hr), NHWC;
        only the last lr stack is kept, as at eval in the JAX package."""
        img_sr, f_lr, f_hr = self.super_resolution(images_lr)
        feats_lr = self.image_filter_lr(f_lr)
        feat_hr = self.image_filter_hr(f_hr)[0]
        return img_sr, [feats_lr[-1]], feat_hr

    def point_features(self, feat_lr, feat_hr, points, calibs):
        """-> (x [B, N, 321] float32 = cat(lr, hr, z), mask [B, N])."""
        xyz = orthogonal(points, calibs)
        xy = xyz[:, :2, :]
        mask = in_image_mask(xy)
        z_feat = normalize_depth(xyz[:, 2:3, :], self.load_size,
                                 self.z_size).transpose(1, 2)
        uv = xy.transpose(1, 2)
        x = torch.cat([grid_sample_points(feat_lr, uv),
                       grid_sample_points(feat_hr, uv), z_feat], dim=-1)
        return x, mask

    def query(self, feats_lr: List[torch.Tensor], feat_hr: torch.Tensor,
              points: torch.Tensor, calibs: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """points [B, 3, N] -> (pred_hr, pred_lr) [B, N] from the last
        stack, masked to the image after the sigmoid."""
        x, mask = self.point_features(feats_lr[-1], feat_hr, points, calibs)
        pred_lr = self.mlp_lr(x)
        pred_hr = self.mlp_hr(torch.cat([x, pred_lr], dim=-1))
        return pred_hr[..., 0] * mask, pred_lr[..., 0] * mask


def surs_net_from_config(cfg, device, seed: int | None = None) -> SuRSNet:
    """Build a SuRSNet for a resolved config (config.resolve_config) on
    ``device``, randomly initialised from ``seed`` (default
    ``cfg.seed``), with the trunk in ``cfg.dtype``."""
    if cfg.num_views != 1:
        raise NotImplementedError("num_views > 1 is not ported")
    net = SuRSNet(
        num_stack_lr=cfg.num_stack_lr, num_stack_hr=cfg.num_stack_hr,
        hg_depth=cfg.hg_depth, hg_dim=cfg.hg_dim, norm=cfg.norm,
        mlp_dim_lr=tuple(cfg.mlp_dim_lr), mlp_dim_hr=tuple(cfg.mlp_dim_hr),
        mlp_res_layers_lr=tuple(cfg.mlp_res_layers_lr),
        mlp_res_layers_hr=tuple(cfg.mlp_res_layers_hr),
        no_residual=cfg.no_residual, n_block=tuple(cfg.n_block),
        residual=cfg.residual, scale=cfg.scale, load_size=cfg.loadSize,
        z_size=cfg.z_size)
    gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
    init_weights(net, gen)
    return net.to(device).set_trunk_dtype(_DTYPES[cfg.dtype]).eval()
