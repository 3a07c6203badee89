"""UV-space renders for the color branch: UV_RENDER / UV_MASK / UV_POS /
UV_NORMAL (counterpart of ``surs_tpu/render/uv.py``).

The raster target is the UV chart mapped to [-1, 1] at depth 0, and the
interpolated attributes are [world position | normal | vertex color], so
each covered texel holds the surface point, normal and albedo that
``data/datasets.TrainDataset.get_color_sampling`` reads. A mesh without
artist UVs gets a per-triangle atlas chart (:func:`triangle_atlas_uvs`):
every covered texel maps to exactly one surface point. Many small faces
cover no texel; that is the JAX package's behaviour.

The normals, shading and rasterization run on a device (CUDA unless
named) through the port's torch rasterizer (``render/rasterizer.py``).
It weighs F x patch^2 candidates: a 327,680-face mesh at 512 (a 573 x 573
atlas, patch 16) takes 84 M. Geometry maps are view-independent and
written once per subject (``00.*``); UV_RENDER is shaded per yaw with
the SH lighting of the view renderer and written as JPEG through PIL.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import resolve_device
from .camera import yaw_pitch_rotation
from .dataset_gen import _pil_image
from .rasterizer import rasterize
from .shading import default_lighting, sh_shading, vertex_normals


def triangle_atlas_uvs(n_faces: int, margin: float = 0.15) -> np.ndarray:
    """Per-face chart: a ceil(sqrt(F))-square grid of right triangles,
    each inset by ``margin`` of its cell. Returns corner uvs [F, 3, 2]
    float32 in [0, 1]; the map UV -> surface is affine per triangle."""
    G = int(np.ceil(np.sqrt(n_faces)))
    s = 1.0 / G
    m = margin * s
    f = np.arange(n_faces)
    gx = (f % G).astype(np.float64) * s
    gy = (f // G).astype(np.float64) * s
    uv = np.empty((n_faces, 3, 2), np.float64)
    uv[:, 0, 0] = gx + m
    uv[:, 0, 1] = gy + m
    uv[:, 1, 0] = gx + s - m
    uv[:, 1, 1] = gy + m
    uv[:, 2, 0] = gx + m
    uv[:, 2, 1] = gy + s - m
    return uv.astype(np.float32)


def _atlas_patch(n_faces: int, uv_size: int) -> int:
    """The rasterizer's patch covering one atlas cell (at least 16)."""
    G = int(np.ceil(np.sqrt(n_faces)))
    return max(16, int(np.ceil(uv_size / G)) + 2)


def render_uv_maps(verts: np.ndarray, faces: np.ndarray,
                   uv_corner: Optional[np.ndarray] = None,
                   colors: Optional[np.ndarray] = None,
                   uv_size: int = 512, patch: Optional[int] = None,
                   device=None) -> Tuple[np.ndarray, np.ndarray,
                                         np.ndarray, np.ndarray]:
    """The view-independent UV maps on ``device`` (CUDA unless named).

    uv_corner: [F, 3, 2] corner chart coordinates in [0, 1] (default the
    triangle atlas). colors: per-vertex rgb in [0, 1] (default 0.75).
    Returns numpy (pos [S, S, 3] float32, normal [S, S, 3] float32 unit,
    albedo [S, S, 3] float32, mask [S, S] bool)."""
    device = resolve_device(device)
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int64)
    F = faces.shape[0]
    if uv_corner is None:
        uv_corner = triangle_atlas_uvs(F)
    if patch is None:
        patch = _atlas_patch(F, uv_size)
    verts_t = torch.as_tensor(verts, device=device)
    faces_t = torch.as_tensor(faces, device=device)
    vn = vertex_normals(verts_t, faces_t)
    base = (torch.as_tensor(np.asarray(colors, np.float32), device=device)
            if colors is not None
            else torch.full((verts.shape[0], 3), 0.75, device=device))

    # one vertex per corner, so that the chart may be discontinuous
    corner_ids = faces_t.reshape(-1)                     # [F*3]
    uv_flat = torch.as_tensor(np.asarray(uv_corner, np.float32),
                              device=device).reshape(-1, 2)
    raster = torch.cat([uv_flat * 2.0 - 1.0,
                        torch.zeros((uv_flat.shape[0], 1), device=device)],
                       dim=1)
    faces_uv = torch.arange(F * 3, device=device).reshape(F, 3)
    attrs = torch.cat([verts_t[corner_ids], vn[corner_ids],
                       base[corner_ids]], dim=1)         # [F*3, 9]
    img, mask, _ = rasterize(raster, faces_uv, attrs, res=uv_size,
                             patch=patch)
    nrm = img[..., 3:6]
    nrm = nrm / torch.clamp(torch.linalg.norm(nrm, dim=-1, keepdim=True),
                            min=1e-12)
    return (img[..., 0:3].cpu().numpy(), nrm.cpu().numpy(),
            img[..., 6:9].cpu().numpy(), mask.cpu().numpy())


def render_uv_dataset(obj_dir: str, out_root: str, uv_size: int = 512,
                      yaw_step: int = 1,
                      subjects: Optional[Sequence[str]] = None,
                      sh_coeffs: Optional[np.ndarray] = None,
                      device=None) -> None:
    """Write ``UV_MASK/<s>/00.png``, ``UV_POS/<s>/00.exr``,
    ``UV_NORMAL/<s>/00.png`` and ``UV_RENDER/<s>/<yaw>_0_00.jpg`` (one
    every ``yaw_step`` degrees) for every ``obj_dir/<s>_HR.obj``, its
    vertex colors used where every vertex has one; rendered and shaded on
    ``device`` (CUDA unless named)."""
    from ..recon.mesh_io import load_obj
    from ..utils.exr import write_exr

    Image = _pil_image()
    device = resolve_device(device)
    if sh_coeffs is None:
        sh_coeffs = default_lighting()
    if subjects is None:
        subjects = sorted({f[:-7] for f in os.listdir(obj_dir)
                           if f.endswith("_HR.obj")})
    yaws = list(range(0, 360, yaw_step))
    for subject in subjects:
        verts, faces, colors = load_obj(
            os.path.join(obj_dir, subject + "_HR.obj"), with_colors=True)
        pos, nrm, albedo, mask = render_uv_maps(verts, faces, colors=colors,
                                                uv_size=uv_size,
                                                device=device)
        for d in ("UV_RENDER", "UV_MASK", "UV_POS", "UV_NORMAL"):
            os.makedirs(os.path.join(out_root, d, subject), exist_ok=True)
        Image.fromarray((mask * 255).astype(np.uint8)).save(
            os.path.join(out_root, "UV_MASK", subject, "00.png"))
        write_exr(os.path.join(out_root, "UV_POS", subject, "00.exr"),
                  pos.astype(np.float32))
        nrm_png = ((np.clip(nrm, -1.0, 1.0) + 1.0) * 0.5 * 255.0
                   ).astype(np.uint8)
        Image.fromarray(nrm_png).save(
            os.path.join(out_root, "UV_NORMAL", subject, "00.png"))

        # per-yaw shading: the normals rotated into camera space
        nrm_flat = torch.as_tensor(nrm.reshape(-1, 3), device=device)
        alb_flat = albedo.reshape(-1, 3)
        mask_u8 = mask[..., None].astype(np.uint8)
        for yaw in yaws:
            R = yaw_pitch_rotation(yaw, 0.0)
            n_cam = nrm_flat @ torch.as_tensor(R.T, dtype=torch.float32,
                                               device=device)
            shade = torch.clamp(sh_shading(n_cam, sh_coeffs),
                                min=0.0).cpu().numpy()
            rgb = np.clip(alb_flat * shade[:, None], 0.0, 1.0)
            rgb = (rgb.reshape(uv_size, uv_size, 3) * 255).astype(
                np.uint8) * mask_u8
            Image.fromarray(rgb).save(os.path.join(
                out_root, "UV_RENDER", subject, f"{yaw}_0_00.jpg"))
