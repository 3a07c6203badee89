"""Pixel-aligned bilinear feature sampling
(counterpart of ``surs_tpu/ops/grid_sample.py:19``).

Four gathers and a weighted sum over NHWC maps: the same function as
``F.grid_sample(mode='bilinear', padding_mode='zeros',
align_corners=True)``, with the sampled features coming back as
``[B, N, C]`` rows for the point MLP. The gathers read the map in its
storage dtype (bf16 on the card); the tap weights and the sum are
float32.
"""

from __future__ import annotations

import torch


def grid_sample_points(feat: torch.Tensor, uv: torch.Tensor
                       ) -> torch.Tensor:
    """feat [B, H, W, C], uv [B, N, 2] in [-1, 1] (x = width axis) ->
    float32 [B, N, C], bilinear with zero padding, align_corners=True."""
    B, H, W, C = feat.shape
    uv = uv.float()
    fx = (uv[..., 0] + 1.0) * 0.5 * (W - 1)
    fy = (uv[..., 1] + 1.0) * 0.5 * (H - 1)
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    wx = fx - x0
    wy = fy - y0
    x0i = x0.long()
    y0i = y0.long()
    flat = feat.reshape(B, H * W, C)
    bidx = torch.arange(B, device=feat.device)[:, None]

    def tap(xi, yi, w):
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        g = flat[bidx, idx]                                  # [B, N, C]
        return g.float() * (w * valid.float())[..., None]

    out = tap(x0i, y0i, (1.0 - wx) * (1.0 - wy))
    out = out + tap(x0i + 1, y0i, wx * (1.0 - wy))
    out = out + tap(x0i, y0i + 1, (1.0 - wx) * wy)
    out = out + tap(x0i + 1, y0i + 1, wx * wy)
    return out
