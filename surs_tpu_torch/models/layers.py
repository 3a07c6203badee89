"""Shared building blocks of the conv trunk
(counterpart of ``surs_tpu/models/layers.py``).

Inside the trunk tensors are NCHW. Submodules carry the Flax module
names, so a Flax param path maps onto a state_dict key by joining with
dots (compat/flax_import.py). Padding is explicit and symmetric, as in
the reference.

Parameters stay float32 and the trunk computes in the dtype of its
input, as Flax's ``dtype=`` does (``surs_tpu/models/layers.py:26-62``):
a convolution casts its weight and bias to the input's dtype at use, and
the norms normalise in float32 and round their output to the input's
dtype. Training therefore updates float32 master weights under a bf16
trunk.

The norms' mode follows the ``train`` argument that every trunk module
takes, as in Flax, never ``nn.Module.training``: a batch norm called
with ``train=False`` normalises with its running statistics and leaves
them alone, whatever mode the module was left in.
"""

from __future__ import annotations

import contextlib

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
    unit/zero GroupNorm affine, BatchNorm scale from N(1, 0.02) and zero
    bias (``surs_tpu/models/layers.py:54-57``, the reference's
    ``init_net``). Draws in module order from ``generator``."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.weight.normal_(0.0, 0.02, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, BatchNorm):
                m.weight.normal_(1.0, 0.02, generator=generator)
                m.bias.zero_()


class BatchNorm(nn.Module):
    """Flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over NCHW:
    statistics over every axis but the channel axis, in float32, the
    variance Flax's fast way (E[x^2] - E[x]^2, clipped at 0). In
    training the batch statistics normalise and the running ones move
    by ``r = 0.9 r + 0.1 s``, the variance biased as the batch's (torch's
    ``F.batch_norm`` would take the unbiased one). There is no
    ``num_batches_tracked``. ``update_stats`` False (``frozen_stats``)
    skips the move: a checkpointed trunk recomputes its forward in the
    backward pass, and the statistics move once a step."""

    eps = 1e-5
    momentum = 0.9

    def __init__(self, channels: int):
        super().__init__()
        self.update_stats = True
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x, train: bool = False):
        xf = x.float()
        if train:
            dims = (0, 2, 3)
            mean = xf.mean(dims)
            var = (xf.square().mean(dims) - mean.square()).clamp_min(0.0)
            if self.update_stats:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
                    self.running_var.mul_(m).add_(var, alpha=1.0 - m)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(x.dtype)


@contextlib.contextmanager
def frozen_stats(module: nn.Module):
    """Within the block no BatchNorm of ``module`` moves its running
    statistics."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m in bns:
            m.update_stats = True


class Norm(nn.Module):
    """GroupNorm with 32 groups and eps 1e-5 (Flax name ``gn``), or
    BatchNorm (Flax name ``bn``)."""

    def __init__(self, channels: int, kind: str = "group"):
        super().__init__()
        self.kind = kind
        if kind == "group":
            self.gn = nn.GroupNorm(32, channels, eps=1e-5)
        elif kind == "batch":
            self.bn = BatchNorm(channels)
        else:
            raise ValueError(f"unknown norm {kind!r}")

    def forward(self, x, train: bool = False):
        if self.kind == "batch":
            return self.bn(x, train)
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

    def forward(self, x, train: bool = False):
        out1 = self.conv1(F.relu(self.bn1(x, train)))
        out2 = self.conv2(F.relu(self.bn2(out1, train)))
        out3 = self.conv3(F.relu(self.bn3(out2, train)))
        out = torch.cat([out1, out2, out3], dim=1)
        residual = x
        if self.has_shortcut:
            residual = self.downsample_conv(F.relu(self.bn4(x, train)))
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
