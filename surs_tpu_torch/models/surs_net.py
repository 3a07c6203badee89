"""SuRSNet (counterpart of ``surs_tpu/models/surs_net.py``):

  encode(images_lr, train)          -> (img_sr, feats_lr, feat_hr)
  query_mr / query_sr               -> per-stack coarse / fine occupancy
  query(feats, feat_hr, pts, calib) -> (pred_hr [B, N], pred_lr [B, N])
  forward(train batch)              -> (pred_hr, total, pred_lr, errors)

``query`` is the plain reference chain through the two
SurfaceClassifiers in float32; the serving path scores points with
kernel K1 instead (ops/point_query.py), and the fused train step
(train/fused_step.py) with kernel K2.

The training forward keeps the reference's cross-wiring: the coarse MLP
runs at ``points_hr`` against the HR labels, the fine MLP at
``points_lr`` against the displacement labels, conditioned on the
coarse prediction list. Predictions are masked to the image after the
sigmoid.

``num_views`` V > 1 trains on V views of one item (batch 1, its rows
[V, ...]): the MLPs average over the views halfway, and each view's
in-image mask multiplies the averaged prediction, [V, N, 1], as in the
JAX package, which has no multi-view batch > 1 and no multi-view
serving (ROADMAP.md C7). ``remat`` checkpoints both point MLPs and
``remat_encoder`` the conv trunk (SuRSSR and both HGFilters) under
autograd: the same values and gradients, fewer saved activations.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..ops.geometry import in_image_mask, normalize_depth, orthogonal
from ..ops.grid_sample import grid_sample_points
from .hourglass import HGFilter
from .layers import frozen_stats, init_weights
from .sr_net import SuRSSR
from .surface_classifier import SurfaceClassifier

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def surs_loss(preds_lr, preds_hr, img_sr, images_hr, labels_lr,
              labels_hr, weights) -> Dict[str, torch.Tensor]:
    """The 4-term loss (``surs_tpu/models/surs_net.py:196-212``):
    stack-averaged MSE of the coarse and fine predictions, L1 of the
    super-resolved image and the displacement MSE of the last stack.
    ``weights`` = (w_mlp1, w_mlp2, w_sr, w_disp)."""
    e_mlp1 = sum(torch.mean((p - labels_hr) ** 2) for p in preds_lr)
    e_mlp1 = e_mlp1 / len(preds_lr)
    e_mlp2 = sum(torch.mean((p - labels_lr) ** 2) for p in preds_hr)
    e_mlp2 = e_mlp2 / len(preds_hr)
    e_sr = torch.mean(torch.abs(img_sr - images_hr))
    disp_gt = labels_lr - labels_hr
    disp_pred = preds_hr[-1] - preds_lr[-1]
    e_disp = torch.mean((disp_gt - disp_pred) ** 2)
    w1, w2, w3, w4 = weights
    total = w1 * e_mlp1 + w2 * e_mlp2 + w3 * e_sr + w4 * e_disp
    return {"mlp1": e_mlp1, "mlp2": e_mlp2, "sr": e_sr, "disp": e_disp,
            "total": total}


class SuRSNet(nn.Module):
    def __init__(self, num_stack_lr: int = 3, num_stack_hr: int = 1,
                 hg_depth: int = 2, hg_dim: int = 256, norm: str = "group",
                 mlp_dim_lr: Sequence[int] = (321, 1024, 512, 256, 128, 1),
                 mlp_dim_hr: Sequence[int] = (322, 1024, 512, 256, 128, 1),
                 mlp_res_layers_lr: Sequence[int] = (2, 3, 4),
                 mlp_res_layers_hr: Sequence[int] = (2, 3, 4),
                 no_residual: bool = False, num_views: int = 1,
                 n_block=(2, 2, 2), residual: bool = False, scale: int = 2,
                 load_size: int = 512, z_size: float = 200.0,
                 w_mlp1: float = 1.0, w_mlp2: float = 1.0,
                 w_sr: float = 1.0, w_disp: float = 1.0,
                 remat: bool = False, remat_encoder: bool = False):
        super().__init__()
        self.norm = norm
        self.num_views = num_views
        self.remat = remat
        self.remat_encoder = remat_encoder
        self.load_size = load_size
        self.z_size = z_size
        self.loss_weights = (w_mlp1, w_mlp2, w_sr, w_disp)
        self.super_resolution = SuRSSR(n_block, residual, scale)
        self.image_filter_lr = HGFilter(num_stack_lr, hg_depth, 256, hg_dim,
                                        norm, "low_res")
        self.image_filter_hr = HGFilter(num_stack_hr, hg_depth, 64, 64,
                                        norm, "high_res")
        self.mlp_lr = SurfaceClassifier(mlp_dim_lr, mlp_res_layers_lr,
                                        no_residual, num_views)
        self.mlp_hr = SurfaceClassifier(mlp_dim_hr, mlp_res_layers_hr,
                                        no_residual, num_views)

    def set_trunk_dtype(self, dtype: torch.dtype) -> "SuRSNet":
        """Compute the conv trunk (SuRSSR and both HGFilters) in
        ``dtype``; the parameters and the point MLPs stay float32."""
        for m in (self.super_resolution, self.image_filter_lr,
                  self.image_filter_hr):
            m.compute_dtype = dtype
        return self

    @staticmethod
    def _run(module: nn.Module, remat: bool, *args):
        """``module(*args)``; with ``remat`` under autograd, checkpointed:
        the backward pass recomputes its forward, in which its batch
        norms keep their running statistics (they moved once, in the
        first forward)."""
        if not (remat and torch.is_grad_enabled()):
            return module(*args)
        return checkpoint(module, *args, use_reentrant=False,
                          context_fn=lambda: (contextlib.nullcontext(),
                                              frozen_stats(module)))

    def encode(self, images_lr: torch.Tensor, train: bool = False):
        """images_lr [B, S, S, 3] -> (img_sr, feats_lr, feat_hr), NHWC;
        eval keeps only the last lr stack, training keeps all. ``train``
        also sets the batch norms' mode."""
        remat = self.remat_encoder
        img_sr, f_lr, f_hr = self._run(self.super_resolution, remat,
                                       images_lr)
        feats_lr = self._run(self.image_filter_lr, remat, f_lr, train)
        if not train:
            feats_lr = [feats_lr[-1]]
        feat_hr = self._run(self.image_filter_hr, remat, f_hr, train)[0]
        return img_sr, feats_lr, feat_hr

    def project(self, points, calibs):
        """points [B, 3, N] -> (uv [B, N, 2], z_feat [B, N, 1],
        mask [B, N])."""
        xyz = orthogonal(points, calibs)
        xy = xyz[:, :2, :]
        z_feat = normalize_depth(xyz[:, 2:3, :], self.load_size,
                                 self.z_size).transpose(1, 2)
        return xy.transpose(1, 2), z_feat, in_image_mask(xy)

    @staticmethod
    def stack_features(feats_lr, feat_hr, uv, z_feat) -> List[torch.Tensor]:
        """Per-stack float32 point features cat(lr_i, hr, z) [B, N, 321]."""
        hr = grid_sample_points(feat_hr, uv)
        return [torch.cat([grid_sample_points(f, uv), hr, z_feat], dim=-1)
                for f in feats_lr]

    def query_mr(self, feats_lr, feat_hr, points, calibs
                 ) -> List[torch.Tensor]:
        """Coarse occupancy per stack, [B, N, 1] each."""
        uv, z_feat, mask = self.project(points, calibs)
        return [mask[..., None] * self._run(self.mlp_lr, self.remat, pf)
                for pf in self.stack_features(feats_lr, feat_hr, uv, z_feat)]

    def query_sr(self, feats_lr, feat_hr, points, calibs, preds_lr
                 ) -> List[torch.Tensor]:
        """Fine occupancy per stack, conditioned on the coarse list."""
        uv, z_feat, mask = self.project(points, calibs)
        pfs = self.stack_features(feats_lr, feat_hr, uv, z_feat)
        return [mask[..., None] * self._run(self.mlp_hr, self.remat,
                                            torch.cat([pf, p], dim=-1))
                for pf, p in zip(pfs, preds_lr)]

    def query(self, feats_lr: List[torch.Tensor], feat_hr: torch.Tensor,
              points: torch.Tensor, calibs: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """points [B, 3, N] -> (pred_hr, pred_lr) [B, N] from the last
        stack, masked to the image after the sigmoid."""
        preds_lr = self.query_mr(feats_lr[-1:], feat_hr, points, calibs)
        preds_hr = self.query_sr(feats_lr[-1:], feat_hr, points, calibs,
                                 preds_lr)
        return preds_hr[-1][..., 0], preds_lr[-1][..., 0]

    def forward(self, images_lr, images_hr, points_lr, points_hr, calibs,
                labels_lr=None, labels_hr=None, train: bool = True):
        """Training forward. images_lr [B, S, S, 3], images_hr
        [B, 2S, 2S, 3], points_* [B, 3, N], calibs [B, 4, 4], labels_hr
        (occupancy) and labels_lr (displacement) [B, N, 1]. Returns
        (pred_hr [B, N, 1], total, pred_lr [B, N, 1], errors); without
        labels total is 0 and errors empty. With ``num_views`` V > 1 the
        rows are the V views of one item (the predictions [V, N, 1])."""
        if self.num_views > 1 and images_lr.shape[0] != self.num_views:
            raise ValueError(
                f"num_views={self.num_views} trains one item at a time "
                f"(its views as the rows); got {images_lr.shape[0]} rows. "
                "The JAX package's mask broadcast fails there too "
                "(ROADMAP.md C7)")
        img_sr, feats_lr, feat_hr = self.encode(images_lr, train=train)
        preds_lr = self.query_mr(feats_lr, feat_hr, points_hr, calibs)
        preds_hr = self.query_sr(feats_lr, feat_hr, points_lr, calibs,
                                 preds_lr)
        errors: Dict[str, torch.Tensor] = {}
        total = 0.0
        if labels_hr is not None and labels_lr is not None:
            errors = surs_loss(preds_lr, preds_hr, img_sr, images_hr,
                               labels_lr, labels_hr, self.loss_weights)
            total = errors["total"]
        return preds_hr[-1], total, preds_lr[-1], errors


def surs_net_from_config(cfg, device, seed: int | None = None) -> SuRSNet:
    """Build a SuRSNet for a resolved config (config.resolve_config) on
    ``device``, randomly initialised from ``seed`` (default
    ``cfg.seed``), float32 parameters, the trunk computing in
    ``cfg.dtype``."""
    net = SuRSNet(
        num_stack_lr=cfg.num_stack_lr, num_stack_hr=cfg.num_stack_hr,
        hg_depth=cfg.hg_depth, hg_dim=cfg.hg_dim, norm=cfg.norm,
        mlp_dim_lr=tuple(cfg.mlp_dim_lr), mlp_dim_hr=tuple(cfg.mlp_dim_hr),
        mlp_res_layers_lr=tuple(cfg.mlp_res_layers_lr),
        mlp_res_layers_hr=tuple(cfg.mlp_res_layers_hr),
        no_residual=cfg.no_residual, num_views=cfg.num_views,
        n_block=tuple(cfg.n_block),
        residual=cfg.residual, scale=cfg.scale, load_size=cfg.loadSize,
        z_size=cfg.z_size, w_mlp1=cfg.mlp1, w_mlp2=cfg.mlp2,
        w_sr=cfg.srweight, w_disp=cfg.dispweight, remat=cfg.remat,
        remat_encoder=cfg.remat_encoder)
    gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
    init_weights(net, gen)
    return net.to(device).set_trunk_dtype(_DTYPES[cfg.dtype]).eval()
