"""Stacked-hourglass feature extractor
(counterpart of ``surs_tpu/models/hourglass.py``).

``low_res``: a ConvBlock stem, then ``num_stack`` hourglasses with
intermediate outputs. ``high_res``: a single 1x1 ``conv5``. Downsampling
is 2x average pooling, upsampling bicubic with align_corners=True.
NHWC in and out; NCHW inside.
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
    (``b1_<lv>``, ``b2_<lv>``, ``b2_plus_1``, ``b3_<lv>``)."""

    def __init__(self, depth: int, features: int, norm: str = "group"):
        super().__init__()
        self.depth = depth
        for lv in range(depth, 0, -1):
            names = ["b1", "b2", "b3"] + (["b2_plus"] if lv == 1 else [])
            for n in names:
                self.add_module(f"{n}_{lv}",
                                ConvBlock(features, features, norm))

    def _level(self, lv: int, x):
        up1 = getattr(self, f"b1_{lv}")(x)
        low1 = getattr(self, f"b2_{lv}")(avg_pool_2x(x))
        if lv > 1:
            low2 = self._level(lv - 1, low1)
        else:
            low2 = getattr(self, f"b2_plus_{lv}")(low1)
        low3 = getattr(self, f"b3_{lv}")(low2)
        return up1 + bicubic_upsample(low3, 2, align_corners=True)

    def forward(self, x):
        return self._level(self.depth, x)


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
        if down_type != "low_res":
            raise NotImplementedError(
                f"HGFilter down_type={down_type!r} is not ported")
        self.conv2 = ConvBlock(in_ch, 256, norm)
        for i in range(num_stack):
            self.add_module(f"m{i}", HourGlass(depth, 256, norm))
            self.add_module(f"top_m_{i}", ConvBlock(256, 256, norm))
            self.add_module(f"conv_last{i}", conv(256, 256, 1))
            self.add_module(f"bn_end{i}", Norm(256, norm))
            self.add_module(f"l{i}", conv(256, last_ch, 1))
            if i < num_stack - 1:
                self.add_module(f"bl{i}", conv(256, 256, 1))
                self.add_module(f"al{i}", conv(last_ch, 256, 1))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x [B, H, W, C] -> list of [B, H, W, last_ch] (one per stack),
        in ``compute_dtype``."""
        x = x.permute(0, 3, 1, 2).to(self.compute_dtype)

        def nhwc(t):
            return t.permute(0, 2, 3, 1).contiguous()

        if self.down_type == "high_res":
            return [nhwc(self.conv5(x))]
        previous = self.conv2(x)
        outputs = []
        for i in range(self.num_stack):
            hg = getattr(self, f"m{i}")(previous)
            ll = getattr(self, f"top_m_{i}")(hg)
            ll = getattr(self, f"conv_last{i}")(ll)
            ll = F.relu(getattr(self, f"bn_end{i}")(ll))
            tmp_out = getattr(self, f"l{i}")(ll)
            outputs.append(nhwc(tmp_out))
            if i < self.num_stack - 1:
                previous = (previous + getattr(self, f"bl{i}")(ll)
                            + getattr(self, f"al{i}")(tmp_out))
        return outputs
