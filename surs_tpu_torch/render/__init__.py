"""Rendering: the camera, the torch rasterizer, SH shading and the
dataset renderer (the ported part of ``surs_tpu/render``; PRT shading is
ROADMAP.md A14, UV renders A11, the turntable A14)."""

from .camera import OrthoCamera, fit_camera, yaw_pitch_rotation
from .dataset_gen import render_dataset, render_views
from .rasterizer import rasterize
from .shading import (default_lighting, lambert_shading, sh9_basis,
                      sh_shading, vertex_normals)

__all__ = [
    "OrthoCamera", "fit_camera", "yaw_pitch_rotation", "rasterize",
    "vertex_normals", "sh9_basis", "sh_shading", "lambert_shading",
    "default_lighting", "render_views", "render_dataset",
]
