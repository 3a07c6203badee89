"""Turntable visualization of result meshes (counterpart of
``surs_tpu/render/turntable.py``): N yaw frames of a mesh rendered by the
port's ``render_views`` on a device (CUDA unless named) and saved as an
animated GIF. PIL writes the GIF; it is imported inside the functions,
and without it they raise an error that names PIL.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .dataset_gen import _pil_image, render_views

_GIF = "writing a turntable GIF"


def turntable_frames(verts: np.ndarray, faces: np.ndarray,
                     n_frames: int = 36, res: int = 256, patch: int = 16,
                     device=None) -> List[np.ndarray]:
    """``n_frames`` RGB frames [res, res, 3] uint8 at yaws evenly spaced
    over 360 degrees, rendered on ``device`` (CUDA unless named)."""
    yaws = np.linspace(0, 360, n_frames, endpoint=False)
    return [rgb for _, rgb, _, _ in
            render_views(verts, faces, res, yaws, patch=patch,
                         device=device)]


def save_gif(frames: List[np.ndarray], path: str,
             duration_ms: int = 80) -> None:
    """The frames as a looping GIF, ``duration_ms`` a frame."""
    Image = _pil_image(_GIF)
    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=duration_ms, loop=0)


def turntable_gif(obj_path: str, out_path: str, n_frames: int = 36,
                  res: int = 256, device=None) -> None:
    """Load an OBJ (the port's reader) and save its turntable GIF."""
    from ..recon.mesh_io import load_obj
    _pil_image(_GIF)                     # before the frames are rendered
    verts, faces = load_obj(obj_path)
    save_gif(turntable_frames(verts, faces, n_frames, res, device=device),
             out_path)
