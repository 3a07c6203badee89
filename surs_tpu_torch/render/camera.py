"""Camera model for dataset rendering (the port's copy of
``surs_tpu/render/camera.py``, numpy): the orthographic geometry the
data pipeline consumes, a PARAM dict with ``ortho_ratio`` (pixel / world
unit), ``scale`` (world / model unit), ``center`` (look-at point) and
``R`` (model rotation), the fields ``TrainDataset`` reads, so rendered
datasets round-trip through the port's ``data/calib.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np

from ..data.calib import calib_from_param


def yaw_pitch_rotation(yaw_deg: float, pitch_deg: float = 0.0) -> np.ndarray:
    """Model rotation used for the 360-view capture rigs."""
    y = np.deg2rad(yaw_deg)
    p = np.deg2rad(pitch_deg)
    Ry = np.array([[np.cos(y), 0, np.sin(y)],
                   [0, 1, 0],
                   [-np.sin(y), 0, np.cos(y)]])
    Rx = np.array([[1, 0, 0],
                   [0, np.cos(p), -np.sin(p)],
                   [0, np.sin(p), np.cos(p)]])
    return (Rx @ Ry).astype(np.float64)


@dataclass
class OrthoCamera:
    ortho_ratio: float = 0.4       # pixel / world unit
    scale: float = 1.0             # world / model unit
    center: np.ndarray = field(
        default_factory=lambda: np.zeros(3))
    R: np.ndarray = field(default_factory=lambda: np.eye(3))

    def param_dict(self) -> Dict:
        """The PARAM .npy payload consumed by the data pipeline."""
        return {"ortho_ratio": float(self.ortho_ratio),
                "scale": float(self.scale),
                "center": np.asarray(self.center, dtype=np.float64),
                "R": np.asarray(self.R, dtype=np.float64)}

    def world_to_uv(self, verts: np.ndarray, load_size: int) -> np.ndarray:
        """[V, 3] world -> [V, 3] uv (x,y in [-1,1], y down; z in uv
        units). Mirrors intrinsic @ extrinsic of data/calib.py."""
        calib, _ = calib_from_param(self.param_dict(), load_size)
        v = np.concatenate([verts, np.ones((verts.shape[0], 1))], axis=1)
        return (calib @ v.T).T[:, :3]


def fit_camera(verts: np.ndarray, load_size: int,
               coverage: float = 0.9) -> OrthoCamera:
    """Frame a mesh: center on its bbox, pick ortho_ratio so the larger
    extent fills ``coverage`` of the image."""
    bb_min = verts.min(axis=0)
    bb_max = verts.max(axis=0)
    center = 0.5 * (bb_min + bb_max)
    extent = float((bb_max - bb_min).max())
    # uv_x = (scale/ortho_ratio) * x_cam / (S//2); a vertex extent/2 from
    # center must land at |uv| <= coverage
    ortho_ratio = extent / (coverage * 2.0 * (load_size // 2))
    return OrthoCamera(ortho_ratio=ortho_ratio, scale=1.0, center=center)
