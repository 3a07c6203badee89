"""Dataset-creation rendering: RENDER / MASK / PARAM folders from meshes
(counterpart of ``surs_tpu/render/dataset_gen.py``).

For each yaw the torch rasterizer renders a shaded RGB image and a binary
mask on a device (CUDA unless named), and the PARAM dict that the port's
``data/calib.py`` consumes is saved beside them. Shading is the analytic
SH model on camera-space normals, or with ``prt=`` / ``use_prt=True`` the
reference renderer's shadowed precomputed radiance transfer
(``render/prt.py``).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import resolve_device
from .camera import OrthoCamera, fit_camera, yaw_pitch_rotation
from .prt import RAW_TO_CONV, compute_prt, sh_rotation_matrix
from .rasterizer import rasterize
from .shading import default_lighting, sh_shading, vertex_normals


def _pil_image(what: str = "writing a rendered dataset (its RENDER .jpg "
               "and MASK .png files)"):
    """PIL's Image module, or an error that names PIL and ``what``
    needs it."""
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(f"{what} needs PIL (Pillow), which is not "
                           "installed") from e
    return Image


def render_views(verts: np.ndarray, faces: np.ndarray, load_size: int,
                 yaws: Sequence[float], pitch: float = 0.0,
                 colors: Optional[np.ndarray] = None,
                 sh_coeffs: Optional[np.ndarray] = None,
                 camera: Optional[OrthoCamera] = None, patch: int = 16,
                 prt: Optional[np.ndarray] = None, device=None):
    """Yield (yaw, rgb uint8 [S, S, 3], mask uint8 [S, S], param dict).

    The vertex normals, shading and rasterization run on ``device`` (CUDA
    unless named; raises without a GPU). ``prt``: per-vertex transfer
    vectors [V, 9] (``render/prt.compute_prt``); the shading is then the
    reference's shadowed PRT model (prt.fs ``evaluateLightingModelPRT``),
    the transfer rotated into each view's light frame (prt.vs's SH
    rotation). Without it, the analytic SH model on camera-space
    normals."""
    device = resolve_device(device)
    if camera is None:
        camera = fit_camera(np.asarray(verts), load_size)
    if sh_coeffs is None:
        sh_coeffs = default_lighting()
    verts_t = torch.as_tensor(np.asarray(verts, np.float32), device=device)
    faces_t = torch.as_tensor(np.asarray(faces, np.int64), device=device)
    normals = vertex_normals(verts_t, faces_t)
    base_color = (torch.as_tensor(np.asarray(colors, np.float32),
                                  device=device)
                  if colors is not None
                  else torch.full((verts_t.shape[0], 3), 0.75,
                                  device=device))
    prt_t = sh_prt = None
    if prt is not None:
        prt_t = torch.as_tensor(np.asarray(prt, np.float32), device=device)
        # the transfer vectors live in the cosine-convolved basis
        # (irradiance_basis amplitudes), sh_shading evaluates the raw Y9
        # basis: the lighting is rescaled per band so the same sh_coeffs
        # give the same exposure on both paths
        sh_prt = torch.as_tensor(
            (np.asarray(sh_coeffs, np.float32).T / RAW_TO_CONV).T,
            device=device)

    for yaw in yaws:
        cam = OrthoCamera(camera.ortho_ratio, camera.scale, camera.center,
                          yaw_pitch_rotation(yaw, pitch))
        param = cam.param_dict()
        uv = torch.as_tensor(
            cam.world_to_uv(np.asarray(verts), load_size).astype(np.float32),
            device=device)
        if prt_t is not None:
            M = torch.as_tensor(sh_rotation_matrix(param["R"]),
                                device=device)
            shade = torch.clamp((prt_t @ M) @ sh_prt, min=0.0)
        else:
            # rotate normals into camera space for shading
            n_cam = normals @ torch.as_tensor(
                param["R"].T.astype(np.float32), device=device)
            shade = torch.clamp(sh_shading(n_cam, sh_coeffs), min=0.0)
        attrs = base_color * shade[:, None]
        img, mask, _ = rasterize(uv, faces_t, attrs, res=load_size,
                                 patch=patch)
        rgb = (torch.clamp(img, 0.0, 1.0) * 255).cpu().numpy().astype(
            np.uint8)
        m = mask.cpu().numpy().astype(np.uint8) * 255
        yield yaw, rgb, m, param


def render_dataset(obj_dir: str, out_root: str, load_size: int = 512,
                   yaw_step: int = 1, patch: int = 16,
                   subjects: Optional[Sequence[str]] = None,
                   use_prt: bool = False, prt_dirs: int = 128,
                   prt_grid: int = 96, device=None) -> None:
    """Render a full RENDER / MASK / PARAM training layout from
    ``obj_dir/<subject>_HR.obj`` meshes, one view every ``yaw_step``
    degrees: ``RENDER/<subject>/<yaw>_0_00.jpg``, ``MASK/.../.png`` and
    ``PARAM/.../.npy`` (a pickled dict), as the JAX package writes them.
    The meshes load through the port's OBJ reader; the views render on
    ``device`` (CUDA unless named). ``use_prt`` shades with per-vertex
    shadowed radiance transfer (``compute_prt`` with ``prt_dirs``
    directions on a ``prt_grid`` voxel grid, on ``device``), computed
    once a subject and cached beside the OBJ as ``<subject>_prt.npy``; a
    cache whose vertex count differs from the mesh's is recomputed."""
    from ..recon.mesh_io import load_obj

    Image = _pil_image()
    device = resolve_device(device)
    render_dir = os.path.join(out_root, "RENDER")
    mask_dir = os.path.join(out_root, "MASK")
    param_dir = os.path.join(out_root, "PARAM")
    if subjects is None:
        subjects = sorted({f[:-7] for f in os.listdir(obj_dir)
                           if f.endswith("_HR.obj")})
    yaws = list(range(0, 360, yaw_step))
    for subject in subjects:
        verts, faces = load_obj(os.path.join(obj_dir, subject + "_HR.obj"))
        prt = None
        if use_prt:
            prt_path = os.path.join(obj_dir, subject + "_prt.npy")
            if os.path.exists(prt_path):
                prt = np.load(prt_path)
            if prt is None or prt.shape[0] != verts.shape[0]:
                prt = compute_prt(verts, faces, n_dirs=prt_dirs,
                                  grid=prt_grid, device=device)
                np.save(prt_path, prt)
        for d in (render_dir, mask_dir, param_dir):
            os.makedirs(os.path.join(d, subject), exist_ok=True)
        for yaw, rgb, mask, param in render_views(verts, faces, load_size,
                                                  yaws, patch=patch,
                                                  prt=prt, device=device):
            stem = f"{yaw}_0_00"
            Image.fromarray(rgb).save(
                os.path.join(render_dir, subject, stem + ".jpg"))
            Image.fromarray(mask).save(
                os.path.join(mask_dir, subject, stem + ".png"))
            np.save(os.path.join(param_dir, subject, stem + ".npy"),
                    param, allow_pickle=True)
