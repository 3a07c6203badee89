"""The legacy PIFu nets and the color branch (counterpart of
``surs_tpu/models/pifu_legacy.py``):

  * MultiConvFilter / VGGStyleFilter / ResNetStyleFilter (``BACKBONES``):
    image encoders returning a list of feature maps;
  * MLP: the point MLP with a group norm between layers;
  * ConvPIFuNet: the single-scale pixel-aligned implicit net;
  * VhullNet: the visual-hull oracle (no weights), a test fixture;
  * ResBlkColorNet: the framework's per-point RGB net (resnet-style filter
    and a group-norm MLP with a tanh output);
  * ResnetColorFilter / RefResnetBlock / RefColorNet: the reference
    ResBlkPIFuNet's topology (reflect padding, affine-free instance norm),
    into which a reference netC state dict imports
    (``compat/torch_import.py:import_torch_color_state_dict``).

Images come and feature maps go NHWC, as in the JAX package; the convs
run NCHW inside. Submodules carry the Flax module names, so the weight
bridge (``compat/flax_import.py``) joins a param path with dots. The
nets compute in float32; none of them is on a kernel's path (the JAX
package computes them outside any Pallas kernel too).

The MLP's group norm normalises each group over every point of the call
and the group's channels (Flax's ``GroupNorm`` on [B, N, C]), so a
point's output depends on the other points of its call: callers that
chunk points (``train/color.py:colorize_vertices``) keep the JAX
package's chunks and zero padding.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.geometry import PROJECTIONS, in_image_mask, normalize_depth
from ..ops.grid_sample import grid_sample_points
from .layers import Norm, conv, leaky_relu
from .surface_classifier import SurfaceClassifier


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class MultiConvFilter(nn.Module):
    """Stride-2 4x4 convs with LeakyReLU(0.01); every stage's map is a
    feature (64 + 128 + 128 + 192 = 512 channels, plus depth: 513)."""

    def __init__(self, channels: Sequence[int] = (64, 128, 128, 192),
                 in_ch: int = 3):
        super().__init__()
        self.n = len(channels)
        self.feature_channels = sum(channels)
        for i, c in enumerate(channels):
            self.add_module(f"conv{i}", conv(in_ch, c, 4, stride=2, pad=1))
            in_ch = c

    def forward(self, x) -> List[torch.Tensor]:
        feats, h = [], _nchw(x)
        for i in range(self.n):
            h = leaky_relu(getattr(self, f"conv{i}")(h), 0.01)
            feats.append(_nhwc(h))
        return feats


class VGGStyleFilter(nn.Module):
    """VGG16-style stages of 3x3 convs with ReLU, a 2x2 max pool between
    stages; every stage's last map is a feature."""

    def __init__(self, stages: Sequence[Sequence[int]] = ((64, 64),
                                                           (128, 128),
                                                           (256, 256, 256)),
                 in_ch: int = 3):
        super().__init__()
        self.stages = tuple(tuple(s) for s in stages)
        self.feature_channels = sum(s[-1] for s in self.stages)
        for si, stage in enumerate(self.stages):
            for ci, c in enumerate(stage):
                self.add_module(f"s{si}_c{ci}", conv(in_ch, c, 3, pad=1))
                in_ch = c

    def forward(self, x) -> List[torch.Tensor]:
        feats, h = [], _nchw(x)
        for si, stage in enumerate(self.stages):
            for ci in range(len(stage)):
                h = F.relu(getattr(self, f"s{si}_c{ci}")(h))
            feats.append(_nhwc(h))
            if si < len(self.stages) - 1:
                h = F.max_pool2d(h, 2, 2)
        return feats


class ResNetStyleFilter(nn.Module):
    """A stride-2 7x7 stem, then per stage a stride-2 3x3 down conv and a
    residual pair of group-norm, ReLU, 3x3 conv; the stem's and every
    stage's map are features."""

    def __init__(self, channels: Sequence[int] = (64, 128, 256),
                 in_ch: int = 3):
        super().__init__()
        self.n = len(channels)
        self.feature_channels = 64 + sum(channels)
        self.stem = conv(in_ch, 64, 7, stride=2, pad=3)
        h = 64
        for i, c in enumerate(channels):
            self.add_module(f"down{i}", conv(h, c, 3, stride=2, pad=1))
            self.add_module(f"n{i}a", Norm(c))
            self.add_module(f"conv{i}a", conv(c, c, 3, pad=1))
            self.add_module(f"n{i}b", Norm(c))
            self.add_module(f"conv{i}b", conv(c, c, 3, pad=1))
            h = c

    def forward(self, x) -> List[torch.Tensor]:
        h = F.relu(self.stem(_nchw(x)))
        feats = [_nhwc(h)]
        for i in range(self.n):
            inp = getattr(self, f"down{i}")(h)
            b = F.relu(getattr(self, f"n{i}a")(inp))
            b = getattr(self, f"conv{i}a")(b)
            b = F.relu(getattr(self, f"n{i}b")(b))
            b = getattr(self, f"conv{i}b")(b)
            h = inp + b
            feats.append(_nhwc(h))
        return feats


# each returns a list of NHWC maps; ``feature_channels`` is their sum
BACKBONES = {
    "multiconv": MultiConvFilter,
    "vgg16": VGGStyleFilter,
    "resnet": ResNetStyleFilter,
}


def _point_group_norm(x: torch.Tensor, gn: nn.GroupNorm) -> torch.Tensor:
    """Flax's ``GroupNorm`` on x [B, N, C]: statistics per item and group
    over the N points and the group's channels, the fast variance
    E[x^2] - E[x]^2 clipped at 0, then ``(x - mean) * (rsqrt(var + eps) *
    scale) + bias``."""
    B, N, C = x.shape
    G = gn.num_groups
    xg = x.reshape(B, N, G, C // G)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg.square().mean(dim=(1, 3), keepdim=True)
           - mean.square()).clamp_min(0.0)
    mul = torch.rsqrt(var + gn.eps) * gn.weight.reshape(G, C // G)
    return ((xg - mean) * mul).reshape(B, N, C) + gn.bias


class MLP(nn.Module):
    """Point MLP (``nn.Linear`` layers ``conv{i}``, the input
    ``filter_channels[0]`` wide) with a norm between layers: ``norm``
    'group' puts a 32-group GroupNorm (eps 1e-5, ``norm{i}``,
    :func:`_point_group_norm`) before each LeakyReLU(0.01); anything
    else, none. The input is re-concatenated before the layers in
    ``res_layers``; ``last_op`` 'sigmoid', 'tanh' or none."""

    def __init__(self, filter_channels: Sequence[int],
                 res_layers: Sequence[int] = (), norm: str = "group",
                 last_op: str = "sigmoid"):
        super().__init__()
        self.dims = tuple(filter_channels)
        self.res_layers = tuple(res_layers)
        self.norm = norm
        self.last_op = last_op
        n = len(self.dims) - 1
        for i in range(n):
            d_in = self.dims[i] + (self.dims[0] if i in self.res_layers
                                   else 0)
            self.add_module(f"conv{i}", nn.Linear(d_in, self.dims[i + 1]))
            if i != n - 1 and norm == "group":
                self.add_module(f"norm{i}",
                                nn.GroupNorm(32, self.dims[i + 1], eps=1e-5))

    def forward(self, feature: torch.Tensor) -> torch.Tensor:
        """feature [B, N, C_in] -> [B, N, C_out]."""
        y = tmpy = feature
        n = len(self.dims) - 1
        for i in range(n):
            inp = torch.cat([y, tmpy], -1) if i in self.res_layers else y
            y = getattr(self, f"conv{i}")(inp)
            if i != n - 1:
                if self.norm == "group":
                    y = _point_group_norm(y, getattr(self, f"norm{i}"))
                y = leaky_relu(y, 0.01)
        if self.last_op == "sigmoid":
            return torch.sigmoid(y)
        if self.last_op == "tanh":
            return torch.tanh(y)
        return y


def _point_features(projection_mode: str, points, calibs, transforms,
                    load_size: int, z_size: float):
    """(uv [B, N, 2], z feature [B, N, 1], xy [B, 2, N]) of points
    [B, 3, N]."""
    xyz = PROJECTIONS[projection_mode](points, calibs, transforms)
    xy = xyz[:, :2, :]
    z_feat = normalize_depth(xyz[:, 2:3, :], load_size, z_size).transpose(1, 2)
    return xy.transpose(1, 2), z_feat, xy


class ConvPIFuNet(nn.Module):
    """Single-scale pixel-aligned implicit net: a ``BACKBONES`` filter,
    every map sampled at the point and the depth feature appended, a
    residual-free ``SurfaceClassifier``; 0 outside the image. The
    classifier's input width is the filter's channels + 1, whatever
    ``mlp_dim[0]`` says (Flax's Dense takes it from its input)."""

    def __init__(self, backbone: str = "multiconv",
                 mlp_dim: Sequence[int] = (513, 1024, 512, 256, 128, 1),
                 projection_mode: str = "orthogonal", load_size: int = 512,
                 z_size: float = 200.0):
        super().__init__()
        self.projection_mode = projection_mode
        self.load_size = load_size
        self.z_size = z_size
        self.image_filter = BACKBONES[backbone]()
        self.surface_classifier = SurfaceClassifier(
            (self.image_filter.feature_channels + 1,) + tuple(mlp_dim[1:]),
            res_layers=())

    def encode(self, images) -> List[torch.Tensor]:
        return self.image_filter(images)

    def query(self, feat_list, points, calibs, transforms=None):
        uv, z_feat, xy = _point_features(self.projection_mode, points,
                                         calibs, transforms, self.load_size,
                                         self.z_size)
        mask = in_image_mask(xy)[..., None]
        samples = [grid_sample_points(f, uv) for f in feat_list]
        pf = torch.cat(samples + [z_feat], dim=-1)
        return mask * self.surface_classifier(pf)

    def forward(self, images, points, calibs, transforms=None):
        """images [B, S, S, 3], points [B, 3, N] -> [B, N, 1]."""
        return self.query(self.encode(images), points, calibs, transforms)


class VhullNet:
    """Visual-hull oracle: occupancy 1 where a point projects inside every
    view's mask and the image. Not a learned module."""

    def __init__(self, projection_mode: str = "orthogonal"):
        self.projection = PROJECTIONS[projection_mode]

    def query(self, masks: torch.Tensor, points: torch.Tensor,
              calibs: torch.Tensor) -> torch.Tensor:
        """masks [V, H, W, 1]; points [1, 3, N]; calibs [V, 4, 4] ->
        [1, N]."""
        V = masks.shape[0]
        pts = points.repeat(V, 1, 1)
        xyz = self.projection(pts, calibs)
        uv = xyz[:, :2, :].transpose(1, 2)
        inside = in_image_mask(xyz[:, :2, :])
        samp = grid_sample_points(masks, uv)[..., 0]      # [V, N]
        occ = (samp > 0.5) & (inside > 0.5)
        return torch.prod(occ.float(), dim=0)[None]


class ResBlkColorNet(nn.Module):
    """Per-point color regression: ``ResNetStyleFilter((128, 256, 256))``,
    its last map sampled at the point with the depth feature, and the
    group-norm ``MLP`` with a tanh output: rgb in [-1, 1]. The MLP's input
    is 256 + 1 wide whatever ``mlp_dim_color[0]`` says (513 by default:
    Flax's Dense takes the width from its input)."""

    def __init__(self, mlp_dim_color: Sequence[int] = (513, 1024, 512, 256,
                                                       128, 3),
                 projection_mode: str = "orthogonal", load_size: int = 512,
                 z_size: float = 200.0):
        super().__init__()
        self.projection_mode = projection_mode
        self.load_size = load_size
        self.z_size = z_size
        self.image_filter = ResNetStyleFilter(channels=(128, 256, 256))
        self.color_mlp = MLP((256 + 1,) + tuple(mlp_dim_color[1:]),
                             norm="group", last_op="tanh")

    def encode(self, images) -> torch.Tensor:
        """images [B, S, S, 3] -> the last filter map [B, h, w, 256]."""
        return self.image_filter(images)[-1]

    def query(self, feat, points, calibs, transforms=None):
        uv, z_feat, _ = _point_features(self.projection_mode, points, calibs,
                                        transforms, self.load_size,
                                        self.z_size)
        pf = torch.cat([grid_sample_points(feat, uv), z_feat], dim=-1)
        return self.color_mlp(pf)

    def forward(self, images, points, calibs, transforms=None):
        """images [B, S, S, 3], points [B, 3, N] -> rgb [B, N, 3]."""
        return self.query(self.encode(images), points, calibs, transforms)


def _instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Affine-free instance norm over H and W of NCHW, the biased variance
    (the reference's default ``--norm_color instance``)."""
    return F.instance_norm(x, eps=eps)


def _reflect_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    return F.pad(x, (p, p, p, p), mode="reflect")


class RefResnetBlock(nn.Module):
    """Reflect pad, 3x3 conv, instance norm, ReLU, reflect pad, 3x3 conv,
    instance norm (not in the ``last`` block), residual add."""

    def __init__(self, dim: int, last: bool = False):
        super().__init__()
        self.last = last
        self.conv1 = conv(dim, dim, 3)
        self.conv2 = conv(dim, dim, 3)

    def forward(self, x):
        h = F.relu(_instance_norm(self.conv1(_reflect_pad(x, 1))))
        h = self.conv2(_reflect_pad(h, 1))
        if not self.last:
            h = _instance_norm(h)
        return x + h


class ResnetColorFilter(nn.Module):
    """The reference ResnetFilter: reflect-padded 7x7 stem, two stride-2
    downsamples (ngf -> 2 ngf -> 4 ngf), ``n_blocks`` resnet blocks, the
    last without its second norm. NHWC in and out."""

    def __init__(self, ngf: int = 64, n_blocks: int = 6, in_ch: int = 3):
        super().__init__()
        self.n_blocks = n_blocks
        self.stem = conv(in_ch, ngf, 7)
        self.down0 = conv(ngf, ngf * 2, 3, stride=2, pad=1)
        self.down1 = conv(ngf * 2, ngf * 4, 3, stride=2, pad=1)
        for i in range(n_blocks):
            self.add_module(f"block{i}", RefResnetBlock(
                ngf * 4, last=(i == n_blocks - 1)))

    def forward(self, x) -> torch.Tensor:
        h = F.relu(_instance_norm(self.stem(_reflect_pad(_nchw(x), 3))))
        h = F.relu(_instance_norm(self.down0(h)))
        h = F.relu(_instance_norm(self.down1(h)))
        for i in range(self.n_blocks):
            h = getattr(self, f"block{i}")(h)
        return _nhwc(h)


class RefColorNet(nn.Module):
    """The reference netC (ResBlkPIFuNet): ``ResnetColorFilter`` on the
    image, and the point features of netG's map ``im_feat`` (its last lr
    stack), of the own filter's map and the depth, concatenated (each map
    sampled alone, so the two need not share a size) into a norm-free,
    residual-free ``SurfaceClassifier`` with a tanh output. Its input is
    ``mlp_dim_color[0]`` wide, which must be netG's channels + 256 + 1:
    256 + 256 + 1 = 513 at the reference widths."""

    def __init__(self, mlp_dim_color: Sequence[int] = (513, 1024, 512, 256,
                                                       128, 3),
                 projection_mode: str = "orthogonal", load_size: int = 512,
                 z_size: float = 200.0):
        super().__init__()
        self.projection_mode = projection_mode
        self.load_size = load_size
        self.z_size = z_size
        self.image_filter = ResnetColorFilter()
        self.surface_classifier = SurfaceClassifier(
            tuple(mlp_dim_color), res_layers=(), sigmoid=False, tanh=True)

    def encode(self, images) -> torch.Tensor:
        """images [B, S, S, 3] -> the own filter's map [B, S/4, S/4, 256]."""
        return self.image_filter(images)

    def query(self, own, im_feat, points, calibs, transforms=None):
        uv, z_feat, _ = _point_features(self.projection_mode, points, calibs,
                                        transforms, self.load_size,
                                        self.z_size)
        pf = torch.cat([grid_sample_points(im_feat, uv),
                        grid_sample_points(own, uv), z_feat], dim=-1)
        return self.surface_classifier(pf)

    def forward(self, images, im_feat, points, calibs, transforms=None):
        """images [B, S, S, 3], im_feat [B, h, w, C] (netG's last lr
        stack), points [B, 3, N] -> rgb [B, N, 3] in [-1, 1]."""
        return self.query(self.encode(images), im_feat, points, calibs,
                          transforms)
