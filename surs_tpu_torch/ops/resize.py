"""Bicubic resize and 2x average pooling for the conv trunk
(counterpart of ``surs_tpu/ops/resize.py``).

These run inside the trunk, so they take NCHW tensors. Bicubic uses the
Keys kernel with a = -0.75 (torch's coefficient), written as one dense
``[out, in]`` operator per axis and applied as two float32 products:
``align_corners=False`` in SuRSSR's input upsample
(``surs_tpu/models/sr_net.py:54``), ``True`` in the hourglass decoder
(``surs_tpu/models/hourglass.py:54``). The result is cast back to the
input's dtype.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

_A = -0.75


def _cubic(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    x2 = x * x
    x3 = x2 * x
    return np.where(
        x <= 1.0,
        (_A + 2.0) * x3 - (_A + 3.0) * x2 + 1.0,
        np.where(x < 2.0, _A * (x3 - 5.0 * x2 + 8.0 * x - 4.0), 0.0))


@functools.lru_cache(maxsize=None)
def _resize_matrix(in_size: int, out_size: int,
                   align_corners: bool) -> np.ndarray:
    """Dense [out_size, in_size] bicubic operator (border taps clamp)."""
    i = np.arange(out_size, dtype=np.float64)
    if align_corners:
        src = (np.zeros(1) if out_size == 1
               else i * (in_size - 1) / (out_size - 1))
    else:
        src = (i + 0.5) * (in_size / out_size) - 0.5
    f = np.floor(src)
    t = src - f
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for k in range(-1, 3):
        idx = np.clip(f.astype(np.int64) + k, 0, in_size - 1)
        np.add.at(mat, (np.arange(out_size), idx), _cubic(k - t))
    return mat.astype(np.float32)


def bicubic_upsample(x: torch.Tensor, scale: int,
                     align_corners: bool) -> torch.Tensor:
    """Scale-factor bicubic upsample of an NCHW tensor."""
    H, W = x.shape[-2:]
    kh = torch.from_numpy(_resize_matrix(H, H * scale, align_corners)
                          ).to(x.device)
    kw = torch.from_numpy(_resize_matrix(W, W * scale, align_corners)
                          ).to(x.device)
    y = torch.matmul(kh, x.float())            # [B, C, H*s, W]
    y = torch.matmul(y, kw.t())                # [B, C, H*s, W*s]
    return y.to(x.dtype)


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 average pool of an NCHW tensor."""
    return F.avg_pool2d(x, 2)
