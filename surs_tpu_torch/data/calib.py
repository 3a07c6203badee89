"""Calibration matrices, with the train-time augmentation folded into
the intrinsics (the port's copy of ``surs_tpu/data/calib.py``, numpy
only): the PARAM fields (ortho_ratio, scale, center, R) give the
extrinsic and the scale / uv / translation intrinsics of a 4x4 calib;
``sample_aug_params`` draws flip, scale and translation from an
``np.random.Generator`` in the JAX package's order, so one seed gives
the same augmentation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass
class AugParams:
    flip: bool = False
    scale: float = 1.0          # uniform in [0.9, 1.1] when enabled
    dx: int = 0                 # pixel translation
    dy: int = 0


def extrinsic_from_param(param: dict) -> np.ndarray:
    """[R | -R@center; 0 0 0 1] — world -> camera."""
    R = np.asarray(param["R"], dtype=np.float64)
    center = np.asarray(param["center"], dtype=np.float64).reshape(3)
    translate = -R @ center.reshape(3, 1)
    ext = np.concatenate([R, translate], axis=1)
    return np.concatenate([ext, np.array([[0.0, 0.0, 0.0, 1.0]])], axis=0)


def intrinsic_from_param(param: dict, load_size: int,
                         aug: Optional[AugParams] = None) -> np.ndarray:
    """Scale/uv/translation intrinsics with augmentation folded in."""
    aug = aug or AugParams()
    ortho_ratio = float(param["ortho_ratio"])
    scale = float(param["scale"])

    scale_intrinsic = np.identity(4)
    s = scale / ortho_ratio
    scale_intrinsic[0, 0] = s * (-1.0 if aug.flip else 1.0)
    scale_intrinsic[1, 1] = -s
    scale_intrinsic[2, 2] = s
    if aug.scale != 1.0:
        scale_intrinsic *= aug.scale
        scale_intrinsic[3, 3] = 1.0

    uv_intrinsic = np.identity(4)
    half = float(load_size // 2)
    uv_intrinsic[0, 0] = 1.0 / half
    uv_intrinsic[1, 1] = 1.0 / half
    uv_intrinsic[2, 2] = 1.0 / half

    trans_intrinsic = np.identity(4)
    trans_intrinsic[0, 3] = -aug.dx / half
    trans_intrinsic[1, 3] = -aug.dy / half

    return trans_intrinsic @ uv_intrinsic @ scale_intrinsic


def calib_from_param(param: dict, load_size: int,
                     aug: Optional[AugParams] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(calib 4x4, extrinsic 4x4) as float32."""
    ext = extrinsic_from_param(param)
    intr = intrinsic_from_param(param, load_size, aug)
    return (intr @ ext).astype(np.float32), ext.astype(np.float32)


def sample_aug_params(rng: np.random.Generator, w: int, h: int,
                      load_size: int, random_flip: bool, random_scale: bool,
                      random_trans: bool) -> AugParams:
    """Draw augmentation parameters with the reference's distributions
    (flip p=0.5; scale U[0.9, 1.1]; translate +-(dim - loadSize)/10 px)."""
    aug = AugParams()
    if random_flip and rng.random() > 0.5:
        aug.flip = True
    if random_scale:
        aug.scale = float(rng.uniform(0.9, 1.1))
        w = int(aug.scale * w)
        h = int(aug.scale * h)
    if random_trans:
        tw = th = load_size
        aug.dx = int(rng.integers(-int(round((w - tw) / 10.0)),
                                  int(round((w - tw) / 10.0)) + 1))
        aug.dy = int(rng.integers(-int(round((h - th) / 10.0)),
                                  int(round((h - th) / 10.0)) + 1))
    return aug
