"""Rendering: the camera, the torch rasterizer, SH shading, the dataset
renderer and the color branch's UV renders (the ported part of
``surs_tpu/render``; PRT shading and the turntable are ROADMAP.md A14)."""

from .camera import OrthoCamera, fit_camera, yaw_pitch_rotation
from .dataset_gen import render_dataset, render_views
from .rasterizer import rasterize
from .shading import (default_lighting, lambert_shading, sh9_basis,
                      sh_shading, vertex_normals)
from .uv import render_uv_dataset, render_uv_maps, triangle_atlas_uvs

__all__ = [
    "OrthoCamera", "fit_camera", "yaw_pitch_rotation", "rasterize",
    "vertex_normals", "sh9_basis", "sh_shading", "lambert_shading",
    "default_lighting", "render_views", "render_dataset",
    "triangle_atlas_uvs", "render_uv_maps", "render_uv_dataset",
]
