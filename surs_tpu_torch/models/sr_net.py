"""Super-resolution branch (counterpart of ``surs_tpu/models/sr_net.py``):
bicubic 2x upsample, a 3-level strided-conv encoder and a skip-concat
decoder with 2x pixel shuffles. NHWC in and out; NCHW inside.

  img_sr [B, 2S, 2S, 3]  float32
  f_lr   [B, S/2, S/2, 256]
  f_hr   [B, 2S, 2S, 64]
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..ops.pixel_shuffle import pixel_shuffle
from ..ops.resize import bicubic_upsample
from .layers import ResBlock, conv, leaky_relu_02


class ConvLReLU(nn.Module):
    """conv(k3, p1) + LeakyReLU(0.2)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        self.conv = conv(in_ch, out_ch, 3, stride=stride, pad=1)

    def forward(self, x):
        return leaky_relu_02(self.conv(x))


class SuRSSR(nn.Module):
    # (name, in, out, stride) in forward order
    _UNITS = (("head", 3, 32, 1), ("down1", 32, 32, 2),
              ("tail1_0", 32, 32, 1), ("tail1_1", 32, 64, 1),
              ("down2", 64, 64, 2), ("tail2_0", 64, 64, 1),
              ("tail2_1", 64, 128, 1), ("down3", 128, 128, 2),
              ("tail3_0", 128, 128, 1), ("tail3_1", 128, 256, 1),
              ("bottleneck", 256, 256, 1), ("bott2", 512, 512, 1),
              ("ups2", 256, 256, 1), ("ups3", 128, 128, 1),
              ("ups4", 64, 64, 1), ("last_0", 64, 32, 1))

    def __init__(self, n_block: Sequence[int] = (2, 2, 2),
                 residual: bool = False, scale: int = 2):
        super().__init__()
        self.residual = residual
        self.scale = scale
        self.n_block = tuple(n_block)
        self.compute_dtype = torch.float32
        for name, cin, cout, stride in self._UNITS:
            self.add_module(name, ConvLReLU(cin, cout, stride))
        self.last_1 = conv(32, 3, 3, pad=1)
        if residual:
            for lvl, ch in zip((1, 2, 3), (32, 64, 128)):
                for i in range(self.n_block[lvl - 1]):
                    self.add_module(f"body{lvl}_{i}", ResBlock(ch))

    def _body(self, lvl: int, x):
        if self.residual:
            for i in range(self.n_block[lvl - 1]):
                x = getattr(self, f"body{lvl}_{i}")(x)
        return x

    def forward(self, x: torch.Tensor):
        """x [B, S, S, 3] -> (img_sr, f_lr, f_hr), NHWC; the trunk runs
        in ``compute_dtype``, img_sr comes back float32."""
        x = x.permute(0, 3, 1, 2).to(self.compute_dtype)
        h = self.head(bicubic_upsample(x, self.scale, align_corners=False))
        d1 = self._body(1, self.down1(h))
        d1f = self.tail1_1(self.tail1_0(d1))
        d2 = self._body(2, self.down2(d1f))
        d2f = self.tail2_1(self.tail2_0(d2))
        d3 = self._body(3, self.down3(d2f))
        d3f = self.tail3_1(self.tail3_0(d3))
        bo = self.bottleneck(d3f)
        up1 = self.bott2(torch.cat([d3f, bo], dim=1))
        up1 = leaky_relu_02(pixel_shuffle(up1, 2))
        f_lr = torch.cat([d2f, up1], dim=1)
        up2 = leaky_relu_02(pixel_shuffle(self.ups2(f_lr), 2))
        up3 = self.ups3(torch.cat([d1f, up2], dim=1))
        up3 = leaky_relu_02(pixel_shuffle(up3, 2))
        f_hr = self.ups4(torch.cat([h, up3], dim=1))
        img_sr = self.last_1(self.last_0(f_hr)).float()

        def nhwc(t):
            return t.permute(0, 2, 3, 1).contiguous()
        return nhwc(img_sr), nhwc(f_lr), nhwc(f_hr)
