"""Plain SuRSNet (ECCV 2022 SuRS, ``lib/model/SuRS*.py`` of the
published code) in float32 PyTorch: the super-resolution net, the low-
and high-resolution hourglass filters with group norm, and the two
occupancy MLPs, written as functions over one dict of named tensors.

The parameter names follow the measured program's module tree, so one
dict of weights, made by the benchmark, is loaded into both. Nothing
here imports the program.

Every convolution and linear layer goes through :func:`dense_op`, which
applies the precision mode of :class:`Precision`: ``float32`` (TF32
off), ``tf32`` (operands rounded to TF32's 10 mantissa bits) or ``fp8``
(operands rounded to float8 e4m3 with one scale a tensor); the products
are float32 in each. ``jitter`` (float32, each occupancy moved by at
most 1e-4) is a diagnostic of the check, no control. The two lower modes are the controls of the output
check, and read alike on the card and on the CPU.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

SR_UNITS = (("head", 3, 32, 1), ("down1", 32, 32, 2),
            ("tail1_0", 32, 32, 1), ("tail1_1", 32, 64, 1),
            ("down2", 64, 64, 2), ("tail2_0", 64, 64, 1),
            ("tail2_1", 64, 128, 1), ("down3", 128, 128, 2),
            ("tail3_0", 128, 128, 1), ("tail3_1", 128, 256, 1),
            ("bottleneck", 256, 256, 1), ("bott2", 512, 512, 1),
            ("ups2", 256, 256, 1), ("ups3", 128, 128, 1),
            ("ups4", 64, 64, 1), ("last_0", 64, 32, 1))
MLP_RES = (2, 3, 4)


class Precision:
    """The arithmetic of :func:`dense_op`: one mode for the process."""
    mode = "float32"


@contextlib.contextmanager
def precision(mode: str):
    """Run the block's convolutions and products in ``mode``."""
    if mode not in ("float32", "tf32", "fp8", "jitter"):
        raise ValueError(f"unknown precision {mode!r}")
    old = (Precision.mode, torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    Precision.mode = mode
    # float32 products stay float32 on the card; the lower modes round
    # their operands themselves, alike on the card and the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (Precision.mode, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, to nearest, ties away)."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale (amax to 448)."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    s = amax / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


def _rounded(x: torch.Tensor, rnd) -> torch.Tensor:
    """x rounded by ``rnd``; gradients pass to x unrounded."""
    return x + (rnd(x.detach()) - x).detach()


def dense_op(fn, x, w, *args, **kw):
    """``fn(x, w, ...)`` under the current precision."""
    rnd = {"fp8": fp8_round, "tf32": tf32_round}.get(Precision.mode)
    if rnd is not None:
        x, w = _rounded(x, rnd), _rounded(w, rnd)
    return fn(x, w, *args, **kw)


# ------------------------------------------------------------ params --
def param_shapes(hg_dim: int = 256, num_stack_lr: int = 3,
                 mlp_dim_lr: Sequence[int] = (321, 1024, 512, 256, 128, 1),
                 mlp_dim_hr: Sequence[int] = (322, 1024, 512, 256, 128, 1),
                 hg_depth: int = 2) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's name and shape, in a fixed order."""
    out: Dict[str, Tuple[int, ...]] = {}

    def conv(name, cin, cout, k, bias=True):
        out[name + ".weight"] = (cout, cin, k, k)
        if bias:
            out[name + ".bias"] = (cout,)

    def gn(name, ch):
        out[name + ".gn.weight"] = (ch,)
        out[name + ".gn.bias"] = (ch,)

    def block(name, cin, cout):
        gn(name + ".bn1", cin)
        conv(name + ".conv1", cin, cout // 2, 3, False)
        gn(name + ".bn2", cout // 2)
        conv(name + ".conv2", cout // 2, cout // 4, 3, False)
        gn(name + ".bn3", cout // 4)
        conv(name + ".conv3", cout // 4, cout // 4, 3, False)
        if cin != cout:
            gn(name + ".bn4", cin)
            conv(name + ".downsample_conv", cin, cout, 1, False)

    for name, cin, cout, _ in SR_UNITS:
        conv(f"super_resolution.{name}.conv", cin, cout, 3)
    conv("super_resolution.last_1", 32, 3, 3)
    f = "image_filter_lr"
    block(f + ".conv2", 256, 256)
    for i in range(num_stack_lr):
        for lv in range(hg_depth, 0, -1):
            for n in ["b1", "b2", "b3"] + (["b2_plus"] if lv == 1 else []):
                block(f"{f}.m{i}.{n}_{lv}", 256, 256)
        block(f"{f}.top_m_{i}", 256, 256)
        conv(f"{f}.conv_last{i}", 256, 256, 1)
        gn(f"{f}.bn_end{i}", 256)
        conv(f"{f}.l{i}", 256, hg_dim, 1)
        if i < num_stack_lr - 1:
            conv(f"{f}.bl{i}", 256, 256, 1)
            conv(f"{f}.al{i}", hg_dim, 256, 1)
    conv("image_filter_hr.conv5", 64, 64, 1)
    for mlp, dims in (("mlp_lr", mlp_dim_lr), ("mlp_hr", mlp_dim_hr)):
        for i in range(len(dims) - 1):
            fan_in = dims[i] + (dims[0] if i in MLP_RES else 0)
            out[f"{mlp}.conv{i}.weight"] = (dims[i + 1], fan_in)
            out[f"{mlp}.conv{i}.bias"] = (dims[i + 1],)
    return out


def make_params(shapes: Dict[str, Tuple[int, ...]], seed: int, device,
                std: float = 0.02) -> Params:
    """Random weights from ``seed`` on ``device``: every conv and linear
    weight N(0, std) from one draw, biases 0, group-norm scales 1."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    wnames = [n for n, s in shapes.items()
              if n.endswith(".weight") and len(s) > 1]
    sizes = [int(torch.Size(shapes[n]).numel()) for n in wnames]
    draw = torch.empty(sum(sizes), device=device)
    draw.normal_(0.0, std, generator=gen)
    out: Params = {}
    for n, part in zip(wnames, torch.split(draw, sizes)):
        out[n] = part.view(shapes[n])
    for n, s in shapes.items():
        if n not in out:
            fill = 1.0 if n.endswith(".gn.weight") else 0.0
            out[n] = torch.full(s, fill, device=device)
    return out


# ------------------------------------------------------------- trunk --
def conv2d(x, p: Params, name: str, stride: int = 1, pad: int = 0):
    return dense_op(F.conv2d, x, p[name + ".weight"], p.get(name + ".bias"),
                    stride, pad)


def group_norm(x, p: Params, name: str):
    return F.group_norm(x, 32, p[name + ".gn.weight"], p[name + ".gn.bias"],
                        1e-5)


def conv_block(x, p: Params, name: str):
    out1 = conv2d(F.relu(group_norm(x, p, name + ".bn1")), p,
                  name + ".conv1", pad=1)
    out2 = conv2d(F.relu(group_norm(out1, p, name + ".bn2")), p,
                  name + ".conv2", pad=1)
    out3 = conv2d(F.relu(group_norm(out2, p, name + ".bn3")), p,
                  name + ".conv3", pad=1)
    out = torch.cat([out1, out2, out3], 1)
    if name + ".downsample_conv.weight" in p:
        x = conv2d(F.relu(group_norm(x, p, name + ".bn4")), p,
                   name + ".downsample_conv")
    return out + x


def up2(x, align_corners: bool):
    return F.interpolate(x, scale_factor=2, mode="bicubic",
                         align_corners=align_corners)


def lrelu(x, slope: float):
    return torch.where(x >= 0, x, slope * x)


def sr_net(img: torch.Tensor, p: Params):
    """img [B, 3, S, S] -> (img_sr [B, 3, 2S, 2S], f_lr [B, 256, S/2,
    S/2], f_hr [B, 64, 2S, 2S])."""
    def unit(name, x):
        stride = {n: s for n, _, _, s in SR_UNITS}[name]
        return lrelu(conv2d(x, p, f"super_resolution.{name}.conv", stride,
                            1), 0.2)

    h = unit("head", up2(img, False))
    d1f = unit("tail1_1", unit("tail1_0", unit("down1", h)))
    d2f = unit("tail2_1", unit("tail2_0", unit("down2", d1f)))
    d3f = unit("tail3_1", unit("tail3_0", unit("down3", d2f)))
    bo = unit("bottleneck", d3f)
    up1 = lrelu(F.pixel_shuffle(unit("bott2", torch.cat([d3f, bo], 1)), 2),
                0.2)
    f_lr = torch.cat([d2f, up1], 1)
    u2 = lrelu(F.pixel_shuffle(unit("ups2", f_lr), 2), 0.2)
    u3 = lrelu(F.pixel_shuffle(unit("ups3", torch.cat([d1f, u2], 1)), 2),
               0.2)
    f_hr = unit("ups4", torch.cat([h, u3], 1))
    img_sr = conv2d(unit("last_0", f_hr), p, "super_resolution.last_1",
                    pad=1)
    return img_sr, f_lr, f_hr


def hourglass(x, p: Params, name: str, lv: int):
    up1 = conv_block(x, p, f"{name}.b1_{lv}")
    low1 = conv_block(F.avg_pool2d(x, 2), p, f"{name}.b2_{lv}")
    if lv > 1:
        low2 = hourglass(low1, p, name, lv - 1)
    else:
        low2 = conv_block(low1, p, f"{name}.b2_plus_{lv}")
    low3 = conv_block(low2, p, f"{name}.b3_{lv}")
    return up1 + up2(low3, True)


def hg_filter_lr(x, p: Params, num_stack: int, depth: int = 2
                 ) -> List[torch.Tensor]:
    f = "image_filter_lr"
    previous = conv_block(x, p, f + ".conv2")
    outputs = []
    for i in range(num_stack):
        hg = hourglass(previous, p, f"{f}.m{i}", depth)
        ll = conv2d(conv_block(hg, p, f"{f}.top_m_{i}"), p,
                    f"{f}.conv_last{i}")
        ll = F.relu(group_norm(ll, p, f"{f}.bn_end{i}"))
        tmp = conv2d(ll, p, f"{f}.l{i}")
        outputs.append(tmp)
        if i < num_stack - 1:
            previous = (previous + conv2d(ll, p, f"{f}.bl{i}")
                        + conv2d(tmp, p, f"{f}.al{i}"))
    return outputs


def encode(img_nhwc: torch.Tensor, p: Params, num_stack: int):
    """Normalised image [B, S, S, 3] -> (img_sr, feats_lr list, feat_hr),
    NCHW float32."""
    img_sr, f_lr, f_hr = sr_net(img_nhwc.permute(0, 3, 1, 2).float(), p)
    feats = hg_filter_lr(f_lr, p, num_stack)
    feat_hr = conv2d(f_hr, p, "image_filter_hr.conv5")
    return img_sr, feats, feat_hr


# --------------------------------------------------------------- MLP --
def mlp(x: torch.Tensor, p: Params, name: str, n_layers: int = 5):
    """The occupancy MLP: input re-concatenated before layers 2-4,
    LeakyReLU(0.01) between layers, sigmoid at the end."""
    y = x
    for i in range(n_layers):
        inp = torch.cat([y, x], -1) if i in MLP_RES else y
        y = dense_op(F.linear, inp, p[f"{name}.conv{i}.weight"],
                     p[f"{name}.conv{i}.bias"])
        if i != n_layers - 1:
            y = lrelu(y, 0.01)
    out = torch.sigmoid(y)
    if Precision.mode == "jitter":
        # a diagnostic: float32 with every occupancy moved by at most
        # 1e-4, to see what so small a difference does to the meshes
        out = out + (torch.rand_like(out) * 2.0 - 1.0) * 1e-4
    return out


def sample(feat: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """feat [B, C, H, W], uv [B, N, 2] -> [B, N, C], bilinear,
    align_corners=True, zeros outside."""
    out = F.grid_sample(feat, uv[:, :, None, :], mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out[..., 0].transpose(1, 2)


def project(points: torch.Tensor, calib: torch.Tensor, load_size: int,
            z_size: float):
    """points [B, 3, N] -> (uv [B, N, 2], z feature [B, N, 1], in-image
    mask [B, N])."""
    xyz = torch.bmm(calib[:, :3, :3], points) + calib[:, :3, 3:4]
    uv = xyz[:, :2].transpose(1, 2)
    zf = (xyz[:, 2:3] * float(load_size // 2) / float(z_size)).transpose(
        1, 2)
    inside = ((uv >= -1.0) & (uv <= 1.0)).all(-1).float()
    return uv, zf, inside


def query(feat_lr, feat_hr, points, calib, p: Params, load_size: int,
          z_size: float):
    """Occupancy (hr, lr) [B, N] of the last stack at points [B, 3, N]."""
    uv, zf, inside = project(points, calib, load_size, z_size)
    x = torch.cat([sample(feat_lr, uv), sample(feat_hr, uv), zf], -1)
    lr = inside[..., None] * mlp(x, p, "mlp_lr")
    hr = inside[..., None] * mlp(torch.cat([x, lr], -1), p, "mlp_hr")
    return hr[..., 0], lr[..., 0]
