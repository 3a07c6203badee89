"""Shared building blocks of the conv trunk
(counterpart of ``surs_tpu/models/layers.py``).

Inside the trunk tensors are NCHW. Submodules carry the Flax module
names, so a Flax param path maps onto a state_dict key by joining with
dots (compat/flax_import.py). Padding is explicit and symmetric, as in
the reference.

Parameters stay float32 and the trunk computes in the dtype of its
input, as Flax's ``dtype=`` does (``surs_tpu/models/layers.py:26-62``):
a convolution casts its weight and bias to the input's dtype at use, and
GroupNorm normalises in float32 and rounds its output to the input's
dtype. Training therefore updates float32 master weights under a bf16
trunk.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in its input's dtype (parameters cast at use)."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


def conv(in_ch: int, out_ch: int, kernel: int, stride: int = 1,
         pad: int = 0, use_bias: bool = True) -> Conv2d:
    """Conv2d with explicit torch-style padding."""
    return Conv2d(in_ch, out_ch, kernel, stride=stride, padding=pad,
                  bias=use_bias)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Random init of the JAX package's modules: normal(0, 0.02) conv and
    dense weights, zero biases (``surs_tpu/models/layers.py:20-33``),
    unit/zero GroupNorm affine. Draws in module order from
    ``generator``."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.weight.normal_(0.0, 0.02, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()


class Norm(nn.Module):
    """GroupNorm with 32 groups and eps 1e-5 (Flax name ``gn``)."""

    def __init__(self, channels: int, kind: str = "group"):
        super().__init__()
        if kind != "group":
            raise NotImplementedError(
                f"norm={kind!r} is not ported yet (ROADMAP.md A16 "
                "batch-norm trunks)")
        self.gn = nn.GroupNorm(32, channels, eps=1e-5)

    def forward(self, x):
        return F.group_norm(x.float(), 32, self.gn.weight, self.gn.bias,
                            self.gn.eps).to(x.dtype)


class ConvBlock(nn.Module):
    """Three-way split residual block: 3x3 convs to out/2, out/4, out/4
    channels, concatenated, plus a norm-relu-1x1 shortcut when the
    channel count changes (``surs_tpu/models/layers.py:65``)."""

    def __init__(self, in_planes: int, out_planes: int, norm: str = "group"):
        super().__init__()
        half, quarter = out_planes // 2, out_planes // 4
        self.bn1 = Norm(in_planes, norm)
        self.conv1 = conv(in_planes, half, 3, pad=1, use_bias=False)
        self.bn2 = Norm(half, norm)
        self.conv2 = conv(half, quarter, 3, pad=1, use_bias=False)
        self.bn3 = Norm(quarter, norm)
        self.conv3 = conv(quarter, quarter, 3, pad=1, use_bias=False)
        self.has_shortcut = in_planes != out_planes
        if self.has_shortcut:
            self.bn4 = Norm(in_planes, norm)
            self.downsample_conv = conv(in_planes, out_planes, 1,
                                        use_bias=False)

    def forward(self, x):
        out1 = self.conv1(F.relu(self.bn1(x)))
        out2 = self.conv2(F.relu(self.bn2(out1)))
        out3 = self.conv3(F.relu(self.bn3(out2)))
        out = torch.cat([out1, out2, out3], dim=1)
        residual = x
        if self.has_shortcut:
            residual = self.downsample_conv(F.relu(self.bn4(x)))
        return out + residual


class ResBlock(nn.Module):
    """EDSR-style conv-relu-conv + identity (kernel 3, bias, scale 1)."""

    def __init__(self, n_feat: int, res_scale: float = 1.0):
        super().__init__()
        self.conv0 = conv(n_feat, n_feat, 3, pad=1)
        self.conv1 = conv(n_feat, n_feat, 3, pad=1)
        self.res_scale = res_scale

    def forward(self, x):
        return x + self.conv1(F.relu(self.conv0(x))) * self.res_scale


def leaky_relu(x, slope: float):
    """LeakyReLU with the JAX package's gradient: 1 at x = 0 (flax's
    ``leaky_relu`` is ``where(x >= 0, x, slope * x)``), where
    ``F.leaky_relu`` takes ``slope``. The values are equal; the gradients
    differ wherever a pre-activation is exactly 0, as it is across the
    zero background of masked images."""
    return torch.where(x >= 0, x, slope * x)


def leaky_relu_02(x):
    return leaky_relu(x, 0.2)
