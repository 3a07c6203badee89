"""Stacked-hourglass feature extractor
(counterpart of ``surs_tpu/models/hourglass.py``).

``low_res``: a ConvBlock stem to 256 channels, then ``num_stack``
hourglasses with intermediate outputs. ``conv64``: a ConvBlock stem to 64
channels and ``down_conv2``, a 3x3 stride-2 conv to 128, so the first
hourglass takes 128 channels in (its outer ``b1`` / ``b2`` blocks get
the ``bn4`` / ``downsample_conv`` shortcut, as Flax infers). Its 16-
channel branch needs batch norm, and more than one stack fails at the
first intermediate sum (128 against 256 channels), as in the JAX
package. ``high_res``: a single 1x1 ``conv5``. Downsampling is 2x
average pooling, upsampling bicubic with align_corners=True. NHWC in and
out; NCHW inside. Every module takes ``train``, which sets the batch
norms' mode (models/layers.py).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import avg_pool_2x, bicubic_upsample
from .layers import ConvBlock, Norm, conv


class HourGlass(nn.Module):
    """Recursive hourglass of ConvBlocks; blocks are named as in Flax
    (``b1_<lv>``, ``b2_<lv>``, ``b2_plus_1``, ``b3_<lv>``). The outer
    ``b1`` and ``b2`` take ``in_features`` (default ``features``)."""

    def __init__(self, depth: int, features: int, norm: str = "group",
                 in_features: int | None = None):
        super().__init__()
        self.depth = depth
        in_features = in_features or features
        for lv in range(depth, 0, -1):
            names = ["b1", "b2", "b3"] + (["b2_plus"] if lv == 1 else [])
            for n in names:
                outer = lv == depth and n in ("b1", "b2")
                self.add_module(f"{n}_{lv}", ConvBlock(
                    in_features if outer else features, features, norm))

    def _level(self, lv: int, x, train: bool):
        up1 = getattr(self, f"b1_{lv}")(x, train)
        low1 = getattr(self, f"b2_{lv}")(avg_pool_2x(x), train)
        if lv > 1:
            low2 = self._level(lv - 1, low1, train)
        else:
            low2 = getattr(self, f"b2_plus_{lv}")(low1, train)
        low3 = getattr(self, f"b3_{lv}")(low2, train)
        return up1 + bicubic_upsample(low3, 2, align_corners=True)

    def forward(self, x, train: bool = False):
        return self._level(self.depth, x, train)


class HGFilter(nn.Module):
    def __init__(self, num_stack: int, depth: int, in_ch: int, last_ch: int,
                 norm: str = "group", down_type: str = "low_res"):
        super().__init__()
        self.num_stack = num_stack
        self.down_type = down_type
        self.compute_dtype = torch.float32
        if down_type == "high_res":
            self.conv5 = conv(in_ch, last_ch, 1)
            return
        if down_type == "low_res":
            self.conv2 = ConvBlock(in_ch, 256, norm)
            stem_ch = 256
        elif down_type == "conv64":
            if num_stack > 1:
                raise ValueError(
                    "HGFilter down_type='conv64' takes one stack: its "
                    "128-channel stem cannot be summed with a 256-channel "
                    "stack output (the JAX package fails there too)")
            self.conv2 = ConvBlock(in_ch, 64, norm)
            self.down_conv2 = conv(64, 128, 3, stride=2, pad=1)
            stem_ch = 128
        else:
            raise ValueError(f"unknown down_type {down_type!r}")
        for i in range(num_stack):
            self.add_module(f"m{i}", HourGlass(depth, 256, norm, stem_ch))
            self.add_module(f"top_m_{i}", ConvBlock(256, 256, norm))
            self.add_module(f"conv_last{i}", conv(256, 256, 1))
            self.add_module(f"bn_end{i}", Norm(256, norm))
            self.add_module(f"l{i}", conv(256, last_ch, 1))
            if i < num_stack - 1:
                self.add_module(f"bl{i}", conv(256, 256, 1))
                self.add_module(f"al{i}", conv(last_ch, 256, 1))

    def forward(self, x: torch.Tensor, train: bool = False
                ) -> List[torch.Tensor]:
        """x [B, H, W, C] -> list of [B, H', W', last_ch] (one per
        stack), in ``compute_dtype``; H' = H/2 for ``conv64``."""
        x = x.permute(0, 3, 1, 2).to(self.compute_dtype)

        def nhwc(t):
            return t.permute(0, 2, 3, 1).contiguous()

        if self.down_type == "high_res":
            return [nhwc(self.conv5(x))]
        previous = self.conv2(x, train)
        if self.down_type == "conv64":
            previous = self.down_conv2(previous)
        outputs = []
        for i in range(self.num_stack):
            hg = getattr(self, f"m{i}")(previous, train)
            ll = getattr(self, f"top_m_{i}")(hg, train)
            ll = getattr(self, f"conv_last{i}")(ll)
            ll = F.relu(getattr(self, f"bn_end{i}")(ll, train))
            tmp_out = getattr(self, f"l{i}")(ll)
            outputs.append(nhwc(tmp_out))
            if i < self.num_stack - 1:
                previous = (previous + getattr(self, f"bl{i}")(ll)
                            + getattr(self, f"al{i}")(tmp_out))
        return outputs
