"""Rendering: the camera, the torch rasterizer, SH and PRT shading, the
dataset renderer, the turntable and the color branch's UV renders (the
port of ``surs_tpu/render``)."""

from .camera import OrthoCamera, fit_camera, yaw_pitch_rotation
from .dataset_gen import render_dataset, render_views
from .prt import (compute_prt, irradiance_basis, prt_shading,
                  sh_rotation_matrix)
from .rasterizer import rasterize
from .shading import (default_lighting, lambert_shading, sh9_basis,
                      sh_shading, vertex_normals)
from .turntable import save_gif, turntable_frames, turntable_gif
from .uv import render_uv_dataset, render_uv_maps, triangle_atlas_uvs

__all__ = [
    "OrthoCamera", "fit_camera", "yaw_pitch_rotation", "rasterize",
    "vertex_normals", "sh9_basis", "sh_shading", "lambert_shading",
    "default_lighting", "render_views", "render_dataset",
    "irradiance_basis", "compute_prt", "sh_rotation_matrix", "prt_shading",
    "turntable_frames", "save_gif", "turntable_gif",
    "triangle_atlas_uvs", "render_uv_maps", "render_uv_dataset",
]
