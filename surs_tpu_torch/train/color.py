"""The color branch's training and colored-mesh output (counterpart of
``surs_tpu/train/color.py``):

  * :func:`create_color_state` / :func:`make_color_train_step`: L1, MSE
    or BCE regression of per-point RGB (``--color_loss_type``) through
    the port's optax-rule optimizers (``train/optim.py``);
  * :func:`colorize_vertices` / :func:`colorize_vertices_ref`: the
    trained ``ResBlkColorNet`` or a reference ``RefColorNet`` at mesh
    vertices, for ``--with_color`` OBJ output
    (``recon/mesh_io.save_obj_mesh_with_color``).

Color supervision comes from ``data/sampling.sample_surface_colors`` or
from UV renders (``data/datasets.TrainDataset.get_color_sampling``).

The nets run in float32 with TF32 off for their convolutions and
products (``float32_math``), whatever the caller's flags: on the card the
colors are then float32 colors. A vertex's color from
``ResBlkColorNet`` depends on its chunk: the MLP's group norm takes its
statistics over all ``chunk`` points of a call, the zero points padding
the last chunk among them, as in the JAX package. So the chunk size
(65,536) and the zero padding stay the JAX package's. The filter runs
once per call, as it has no norm across points.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn as nn

from ..models.layers import init_weights
from .losses import COLOR_LOSSES
from .optim import OptaxOptimizer, make_optimizer

CHUNK = 65536


@contextlib.contextmanager
def float32_math():
    """Within the block float32 convolutions and products run in float32
    (TF32 off for cuBLAS and cuDNN); the flags are restored after."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


@dataclass
class ColorState:
    step: int
    net: nn.Module
    optimizer: OptaxOptimizer


def create_color_state(color_net: nn.Module, cfg,
                       generator: torch.Generator, device) -> ColorState:
    """``color_net`` initialised from ``generator`` (the JAX package's
    init: N(0, 0.02) weights, zero biases, unit norm scales), moved to
    ``device``, with ``cfg``'s optimizer (``learning_rate``,
    ``optimizer``, ...)."""
    init_weights(color_net, generator)
    color_net.to(device)
    return ColorState(step=0, net=color_net,
                      optimizer=make_optimizer(cfg, color_net.parameters()))


def _batch_tensors(batch: Dict, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(batch[k], np.float32),
                               device=device)
            for k in ("images", "points", "calibs", "rgbs")}


def make_color_train_step(loss_type: str = "l1") -> Callable:
    """``step(state, batch) -> (state, loss)``. batch: images
    [B, S, S, 3], points [B, 3, N], calibs [B, 4, 4], rgbs [B, N, 3] in
    [-1, 1] (numpy or tensors), moved to the net's device."""
    loss_fn = COLOR_LOSSES[loss_type]

    def step(state: ColorState, batch: Dict):
        device = next(state.net.parameters()).device
        b = _batch_tensors(batch, device)
        with float32_math():
            state.optimizer.zero_grad(set_to_none=True)
            pred = state.net(b["images"], b["points"], b["calibs"])
            loss = loss_fn(pred, b["rgbs"])
            loss.backward()
            state.optimizer.step()
        state.step += 1
        return state, loss.detach()

    return step


def _colorize(query: Callable, verts: np.ndarray, device,
              chunk: int) -> np.ndarray:
    """``query(points [1, 3, chunk]) -> [1, chunk, 3]`` over the vertices
    in zero-padded chunks -> rgb [V, 3] in [0, 1]."""
    V = verts.shape[0]
    out = np.empty((V, 3), np.float32)
    pts_all = torch.as_tensor(np.asarray(verts, np.float32).T.copy(),
                              device=device)
    for s in range(0, V, chunk):
        end = min(s + chunk, V)
        pts = torch.zeros((3, chunk), dtype=torch.float32, device=device)
        pts[:, :end - s] = pts_all[:, s:end]
        pred = query(pts[None])
        out[s:end] = pred[0, :end - s].float().cpu().numpy()
    return np.clip(out * 0.5 + 0.5, 0.0, 1.0)


def _f32(x, device) -> torch.Tensor:
    if not torch.is_tensor(x):
        x = np.asarray(x, np.float32)
    return torch.as_tensor(x, device=device).float()


@torch.inference_mode()
def colorize_vertices(color_net: nn.Module, image, verts: np.ndarray,
                      calib, chunk: int = CHUNK) -> np.ndarray:
    """RGB in [0, 1] of a ``ResBlkColorNet`` at mesh vertices (world
    coordinates [V, 3]); image [1, S, S, 3], calib [1, 4, 4], on the
    net's device."""
    device = next(color_net.parameters()).device
    with float32_math():
        image = _f32(image, device)
        calib = _f32(calib, device)
        feat = color_net.encode(image)
        return _colorize(lambda p: color_net.query(feat, p, calib), verts,
                         device, chunk)


@torch.inference_mode()
def colorize_vertices_ref(color_net: nn.Module, image, im_feat,
                          verts: np.ndarray, calib,
                          chunk: int = CHUNK) -> np.ndarray:
    """:func:`colorize_vertices` for a reference ``RefColorNet``, which
    also samples netG's map ``im_feat`` (its last lr stack, [1, h, w,
    C]; a float32 copy of it is taken, e.g. of the service's bf16 map)."""
    device = next(color_net.parameters()).device
    with float32_math():
        image = _f32(image, device)
        calib = _f32(calib, device)
        im_feat = _f32(im_feat, device)
        own = color_net.encode(image)
        return _colorize(
            lambda p: color_net.query(own, im_feat, p, calib), verts,
            device, chunk)
