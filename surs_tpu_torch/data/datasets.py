"""The training set and the real-image eval set (counterparts of
``TrainDataset`` and ``EvalDataset``, ``surs_tpu/data/datasets.py``).

  train: dataroot/{RENDER,MASK,PARAM}/<subject>/<yaw>_<pitch>_00.{jpg,png,npy},
         dataroot/GEO/OBJ/<subject>_{HR,LR}.obj, dataroot/val.txt, and
         optionally dataroot/SAMPLE_CACHE/<subject>_<draw>.npz
         (``python -m surs_tpu_torch.apps.precompute_samples``) and the
         color branch's UV renders dataroot/UV_RENDER/<subject>/
         <yaw>_<pitch>_00.jpg, UV_MASK/<subject>/00.png, UV_POS/
         <subject>/00.exr, UV_NORMAL/<subject>/00.png
         (``python -m surs_tpu_torch.apps.render_dataset --uv``)
  eval:  dataroot/{image_final,mask_final}/<name>.{jpg,png}, or
         ``cfg.img_path`` / ``cfg.mask_path`` for a single image

Training items are numpy dicts with NHWC images; their augmentations go
through PIL (``data/image.py``) and their sample labels through the
winding-number containment (``ops/containment.py``) on
``contains_device``. Eval images decode through ``data/png.py``: PIL
where it is installed, the port's own PNG reader where it is not (a
``.jpg`` then raises, naming PIL)."""

from __future__ import annotations

import glob
import os
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np

from ..config import resolve_device
from ..recon.mesh_io import load_obj
from .calib import AugParams, calib_from_param, sample_aug_params
from .image import _pil, load_render_mask_pil, process_render
from .png import load_gray, load_rgb
from .sampling import MeshData, sample_points_and_labels


def load_render_mask(render_path: str, mask_path: str
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(RGB [H, W, 3], mask [H, W]) uint8, as PIL's ``convert("RGB")``
    and ``convert("L")`` (``surs_tpu/data/image.py:22``)."""
    return load_rgb(render_path), load_gray(mask_path)


class TrainDataset:
    """THuman-style training set (``surs_tpu/data/datasets.py:32-264``).

    ``phase`` "train" or "test" splits the subjects by ``val.txt``
    (none listed: both phases hold every subject). Item ``index`` is
    subject ``index % subjects``, then yaw, then pitch. In the train
    phase an item draws its augmentations and samples from ``rng``, a
    fresh OS-seeded generator when none is given; in the test phase from
    ``default_rng(cfg.seed)``, whatever is passed. Meshes load through
    the port's native OBJ reader into an LRU cache of ``mesh_cache``
    subjects' meshes. Samples come from a random cached draw where
    ``sample_cache_dir`` (default ``dataroot/SAMPLE_CACHE`` when it
    exists) holds one for the subject, else from the meshes, labelled
    by ``contains_fn(points, mesh)`` or, without one, by the winding
    number on ``contains_device`` (CUDA unless named: raises without a
    GPU)."""

    def __init__(self, cfg, phase: str = "train", mesh_cache: int = 8,
                 contains_fn=None, sample_cache_dir: Optional[str] = None,
                 yaw_list=None, contains_device=None):
        self.cfg = cfg
        self.is_train = phase == "train"
        self.root = cfg.dataroot
        if sample_cache_dir is None:
            default_cache = os.path.join(cfg.dataroot, "SAMPLE_CACHE")
            sample_cache_dir = default_cache if os.path.isdir(
                default_cache) else None
        self.sample_cache_dir = sample_cache_dir
        self.RENDER = os.path.join(self.root, "RENDER")
        self.MASK = os.path.join(self.root, "MASK")
        self.PARAM = os.path.join(self.root, "PARAM")
        self.OBJ = os.path.join(self.root, "GEO", "OBJ")
        # the color branch's UV-space renders (render/uv.py)
        self.UV_RENDER = os.path.join(self.root, "UV_RENDER")
        self.UV_MASK = os.path.join(self.root, "UV_MASK")
        self.UV_POS = os.path.join(self.root, "UV_POS")
        self.UV_NORMAL = os.path.join(self.root, "UV_NORMAL")
        self.B_MIN = np.asarray(cfg.b_min, dtype=float)
        self.B_MAX = np.asarray(cfg.b_max, dtype=float)
        self.yaw_list = list(yaw_list) if yaw_list is not None \
            else list(range(0, 360, 1))
        self.pitch_list = [0]
        self.subjects = self._get_subjects()
        self._mesh_cache: OrderedDict = OrderedDict()
        self._mesh_cache_size = mesh_cache
        self._contains_fn = contains_fn
        self.contains_device = (resolve_device(contains_device)
                                if contains_fn is None else None)
        self._sample_cache_paths: Dict[str, list] = {}

    def get_color_sampling(self, subject: str, yid: int, pid: int = 0,
                           rng: Optional[np.random.Generator] = None
                           ) -> Dict[str, np.ndarray]:
        """Color supervision from the UV renders
        (``surs_tpu/data/datasets.py:66-114``): ``cfg.num_sample_color``
        texels inside the UV mask (without replacement unless the mask
        has fewer), their surface position (UV_POS, ``utils/exr.py``)
        moved along the texel normal by N(0, sigma), paired with the
        yaw's UV_RENDER color in [-1, 1]. Returns {color_samples [3, n],
        rgbs [3, n]} float32. Images are read with PIL."""
        from ..utils.exr import read_exr

        Image = _pil()[0]

        rng = rng or np.random.default_rng()
        yaw = self.yaw_list[yid]
        pitch = self.pitch_list[pid]
        uv_mask = np.asarray(Image.open(
            os.path.join(self.UV_MASK, subject, "00.png")))
        if uv_mask.ndim == 3:
            uv_mask = uv_mask[..., 0]
        uv_mask = uv_mask.reshape(-1) != 0
        uv_render = np.asarray(Image.open(os.path.join(
            self.UV_RENDER, subject, f"{yaw}_{pitch}_00.jpg")).convert("RGB"),
            np.float32).reshape(-1, 3) / 255.0
        uv_normal = np.asarray(Image.open(os.path.join(
            self.UV_NORMAL, subject, "00.png")).convert("RGB"),
            np.float32).reshape(-1, 3) / 255.0 * 2.0 - 1.0
        uv_pos = read_exr(os.path.join(self.UV_POS, subject,
                                       "00.exr")).reshape(-1, 3)

        pts = uv_pos[uv_mask]
        cols = uv_render[uv_mask]
        nrm = uv_normal[uv_mask]
        n = self.cfg.num_sample_color
        if n:
            sel = rng.choice(pts.shape[0], size=n, replace=pts.shape[0] < n)
            pts, cols, nrm = pts[sel], cols[sel], nrm[sel]
        offset = rng.normal(0.0, self.cfg.sigma, (pts.shape[0], 1))
        samples = (pts + offset * nrm).T.astype(np.float32)
        rgbs = (2.0 * cols - 1.0).T.astype(np.float32)
        return {"color_samples": samples, "rgbs": rgbs}

    def has_uv_renders(self) -> bool:
        return os.path.isdir(self.UV_RENDER)

    def _get_subjects(self):
        all_subjects = os.listdir(self.RENDER)
        val_path = os.path.join(self.root, "val.txt")
        # an empty val.txt lists no subject (np.loadtxt would warn)
        var_subjects = (np.loadtxt(val_path, dtype=str).reshape(-1).tolist()
                        if os.path.exists(val_path)
                        and os.path.getsize(val_path) else [])
        if not var_subjects:
            return sorted(all_subjects)
        if self.is_train:
            return sorted(set(all_subjects) - set(var_subjects))
        return sorted(var_subjects)

    def __len__(self):
        return len(self.subjects) * len(self.yaw_list) * len(self.pitch_list)

    def _mesh(self, name: str) -> MeshData:
        if name not in self._mesh_cache:
            verts, faces = load_obj(os.path.join(self.OBJ, name))
            self._mesh_cache[name] = MeshData(verts, faces)
            while len(self._mesh_cache) > self._mesh_cache_size:
                self._mesh_cache.popitem(last=False)
        self._mesh_cache.move_to_end(name)
        return self._mesh_cache[name]

    def _find(self, folder: str, subject: str, vid: int, pitch: int,
              exts=("jpg", "png")) -> str:
        for ext in exts:
            p = os.path.join(folder, subject, f"{vid}_{pitch}_00.{ext}")
            if os.path.isfile(p):
                return p
        raise FileNotFoundError(f"{folder}/{subject}/{vid}_{pitch}_00")

    def get_item(self, index: int,
                 rng: Optional[np.random.Generator] = None) -> Dict:
        if rng is None or not self.is_train:
            rng = np.random.default_rng(
                None if self.is_train else self.cfg.seed)
        sid = index % len(self.subjects)
        tmp = index // len(self.subjects)
        yid = tmp % len(self.yaw_list)
        pid = tmp // len(self.yaw_list)
        subject = os.path.splitext(self.subjects[sid])[0]
        pitch = self.pitch_list[pid]

        # multi-view: views spread evenly around yid
        V = self.cfg.num_views
        n_yaw = len(self.yaw_list)
        if self.cfg.random_multiview and self.is_train:
            vids = list(rng.choice(self.yaw_list, V, replace=False))
        else:
            vids = [self.yaw_list[(yid + n_yaw // V * off) % n_yaw]
                    for off in range(V)]

        views = {k: [] for k in ("img_HR", "img_LR", "mask_HR", "mask_LR",
                                 "calib", "extrinsic")}
        S = self.cfg.loadSize
        for vid in vids:
            param = np.load(os.path.join(self.PARAM, subject,
                                         f"{vid}_{pitch}_00.npy"),
                            allow_pickle=True).item()
            render, mask = load_render_mask_pil(
                self._find(self.RENDER, subject, vid, pitch),
                self._find(self.MASK, subject, vid, pitch,
                           exts=("png", "jpg")))
            if self.is_train:
                pad = int(0.1 * S)
                aug = sample_aug_params(rng, render.size[0] + 2 * pad,
                                        render.size[1] + 2 * pad, S,
                                        self.cfg.random_flip,
                                        self.cfg.random_scale,
                                        self.cfg.random_trans)
            else:
                aug = AugParams()
            calib, extrinsic = calib_from_param(param, S, aug)
            img_hr, img_lr, mask_hr, mask_lr = process_render(
                render, mask, S, self.is_train, aug, rng,
                self.cfg.aug_bri, self.cfg.aug_con, self.cfg.aug_sat,
                self.cfg.aug_hue, self.cfg.aug_blur)
            for k, v in (("img_HR", img_hr), ("img_LR", img_lr),
                         ("mask_HR", mask_hr), ("mask_LR", mask_lr),
                         ("calib", calib), ("extrinsic", extrinsic)):
                views[k].append(v)

        def pack(key):
            arrs = views[key]
            return arrs[0] if V == 1 else np.stack(arrs, axis=0)

        item = {
            "name": subject,
            "sid": sid, "yid": yid, "pid": pid,
            "b_min": self.B_MIN, "b_max": self.B_MAX,
            "img_HR": pack("img_HR"), "img_LR": pack("img_LR"),
            "mask_HR": pack("mask_HR"), "mask_LR": pack("mask_LR"),
            "calib": pack("calib"), "extrinsic": pack("extrinsic"),
        }
        if self.cfg.num_sample_inout:
            cached = self._load_cached_samples(subject, rng)
            if cached is not None:
                item.update(cached)
            else:
                item.update(sample_points_and_labels(
                    self._mesh(subject + "_HR.obj"),
                    self._mesh(subject + "_LR.obj"),
                    self.cfg.num_sample_inout, self.cfg.sigma, self.B_MIN,
                    self.B_MAX, rng, contains_fn=self._contains_fn,
                    device=self.contains_device))
        if self.cfg.num_sample_color and self.has_uv_renders():
            # color supervision rides the same item, from the same rng
            item.update(self.get_color_sampling(subject, yid, pid, rng=rng))
        return item

    def _load_cached_samples(self, subject: str,
                             rng: np.random.Generator) -> Optional[Dict]:
        """A random precomputed draw of the subject (the first one in the
        test phase), or None without a cache or a draw."""
        if not self.sample_cache_dir:
            return None
        paths = self._sample_cache_paths.get(subject)
        if paths is None:
            paths = sorted(glob.glob(os.path.join(
                self.sample_cache_dir, f"{subject}_*.npz")))
            self._sample_cache_paths[subject] = paths
        if not paths:
            return None
        pick = paths[0] if not self.is_train else \
            paths[int(rng.integers(len(paths)))]
        with np.load(pick) as z:
            return {k: z[k] for k in
                    ("samples_HR", "samples_LR", "labels_HR",
                     "labels_disp")}

    def __getitem__(self, index):
        return self.get_item(index)


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
