"""The real-image eval set (counterpart of ``EvalDataset``,
``surs_tpu/data/datasets.py:266-317``): ``dataroot/image_final/`` and
``dataroot/mask_final/`` hold ``<name>.{jpg,png}`` pairs, or
``cfg.img_path`` / ``cfg.mask_path`` name a single image. Images decode
through ``data/png.py``: PIL where it is installed, the port's own PNG
reader where it is not (a ``.jpg`` then raises, naming PIL). The
training set waits for ROADMAP.md A19."""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from .png import load_gray, load_rgb


def load_render_mask(render_path: str, mask_path: str
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(RGB [H, W, 3], mask [H, W]) uint8, as PIL's ``convert("RGB")``
    and ``convert("L")`` (``surs_tpu/data/image.py:22``)."""
    return load_rgb(render_path), load_gray(mask_path)


class EvalDataset:
    """Items: ``name``, ``img_LR`` [1, H, W, 3] masked in [-1, 1],
    ``mask_LR`` [H, W, 1] in [0, 1], the fixed orthographic calibration
    ``calib`` [1, 4, 4] = diag(2, -2, 2, 1), ``b_min``, ``b_max``."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.root = cfg.dataroot
        self.RENDER = os.path.join(self.root, "image_final")
        self.MASK = os.path.join(self.root, "mask_final")
        self.B_MIN = np.asarray(cfg.b_min, dtype=float)
        self.B_MAX = np.asarray(cfg.b_max, dtype=float)
        self.single = bool(cfg.img_path)
        if self.single:
            self.subjects = [os.path.basename(cfg.img_path)]
        else:
            self.subjects = sorted(os.listdir(self.RENDER))

    def __len__(self) -> int:
        return len(self.subjects)

    def __getitem__(self, index: int) -> Dict:
        name = os.path.splitext(self.subjects[index])[0]

        def find(folder, exts):
            for ext in exts:
                p = os.path.join(folder, f"{name}.{ext}")
                if os.path.isfile(p):
                    return p
            raise FileNotFoundError(os.path.join(folder, name))

        if self.single:
            mask_path = self.cfg.mask_path or find(self.MASK, ("png", "jpg"))
            render, mask = load_render_mask(self.cfg.img_path, mask_path)
        else:
            render, mask = load_render_mask(find(self.RENDER, ("jpg", "png")),
                                            find(self.MASK, ("png", "jpg")))
        arr = np.asarray(render, dtype=np.float32) / 255.0
        arr = (arr - 0.5) / 0.5
        m = (np.asarray(mask, dtype=np.float32) / 255.0)[..., None]
        img_lr = (arr * m)[None]                     # [1, H, W, 3]
        calib = np.diag([2.0, -2.0, 2.0, 1.0]).astype(np.float32)[None]
        return {"name": name, "img_LR": img_lr, "mask_LR": m,
                "calib": calib, "b_min": self.B_MIN, "b_max": self.B_MAX}
