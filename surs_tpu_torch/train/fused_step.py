"""The fused training step (counterpart of
``surs_tpu/train/fused_step.py``): the plain step's encode, then each
lr stack's coarse and fine MLP chain through kernel K2's autograd op
(ops/fused_mlp.make_fused_dual_mlp_train_ad), with the reference's
cross-wiring (coarse MLP on the HR sample points, fine MLP on the LR
sample points conditioned on the masked coarse prediction), the in-image
masking of each prediction list and the same 4-term loss. The MLP
weights stay float32, so K2 runs its float32 instantiation.
"""

from __future__ import annotations

from typing import Callable, Dict

from ..models.surs_net import SuRSNet, surs_loss
from ..ops.fused_mlp import make_fused_dual_mlp_train_ad
from .step import make_step


def fused_train_loss(model: SuRSNet, batch: Dict, op=None):
    """-> (total, (errors, pred_hr [B, N, 1], pred_lr [B, N, 1]))."""
    op = op or make_fused_dual_mlp_train_ad()
    img_sr, feats_lr, feat_hr = model.encode(batch["images_lr"], train=True)
    uv_a, z_a, mask_a = model.project(batch["points_hr"], batch["calibs"])
    uv_b, z_b, mask_b = model.project(batch["points_lr"], batch["calibs"])
    pfs_a = model.stack_features(feats_lr, feat_hr, uv_a, z_a)
    pfs_b = model.stack_features(feats_lr, feat_hr, uv_b, z_b)
    B, N = mask_a.shape
    C = pfs_a[0].shape[-1]
    m_a = mask_a.reshape(B * N).contiguous()
    preds_lr, preds_hr = [], []
    for pf_a, pf_b in zip(pfs_a, pfs_b):
        p_hr, p_lr = op(pf_a.reshape(B * N, C).contiguous(),
                        pf_b.reshape(B * N, C).contiguous(), m_a,
                        model.mlp_lr, model.mlp_hr)
        preds_lr.append(mask_a[..., None] * p_lr.view(B, N, 1))
        preds_hr.append(mask_b[..., None] * p_hr.view(B, N, 1))
    errors = surs_loss(preds_lr, preds_hr, img_sr, batch["images_hr"],
                       batch["labels_lr"], batch["labels_hr"],
                       model.loss_weights)
    return errors["total"], (errors, preds_hr[-1], preds_lr[-1])


def make_fused_train_step(model: SuRSNet, optimizer) -> Callable:
    """``step(state, batch) -> (state, metrics)``, the contract of
    train/step.make_train_step. On CUDA tensors each stack launches K2
    (or raises); on the CPU the op takes K2's plain version."""
    del optimizer
    if model.norm == "batch":
        raise ValueError("the fused train step does not thread batch "
                         "statistics; use make_train_step for norm='batch'")
    if model.num_views != 1:
        raise ValueError("the fused train step evaluates the point MLPs on "
                         "flat [B*V, N] rows and cannot fuse views; use "
                         "make_train_step for num_views > 1")
    op = make_fused_dual_mlp_train_ad()
    return make_step(lambda m, batch: fused_train_loss(m, batch, op))
