"""PixelShuffle (depth-to-space) in torch's channel order, NCHW
(counterpart of ``surs_tpu/ops/pixel_shuffle.py``):
out[c, h*r+i, w*r+j] = in[c*r*r + i*r + j, h, w]."""

from __future__ import annotations

import torch


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """[B, C*r*r, H, W] -> [B, C, H*r, W*r]."""
    B, Crr, H, W = x.shape
    C = Crr // (r * r)
    x = x.reshape(B, C, r, r, H, W)            # [B, c, i, j, H, W]
    x = x.permute(0, 1, 4, 2, 5, 3)            # [B, c, H, i, W, j]
    return x.reshape(B, C, H * r, W * r)
