"""Host-side image processing for training (the port's copy of
``surs_tpu/data/image.py``): pad by 0.1 * loadSize, flip / scale /
translate + crop (the geometric parameters come from ``calib.py``, so
image and intrinsics agree), ColorJitter, blur, and the LR pair by a 2x
downscale (mask NEAREST, RGB BICUBIC), mask multiplication and the 0.5
mean / std normalization. Images come back NHWC float32.

Every step goes through the same PIL calls as the JAX package, so one
seed gives the same pixels. PIL is imported inside the functions:
``import surs_tpu_torch.data`` works without it, and these functions
then raise an error that names PIL.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .calib import AugParams


def _pil():
    """PIL's modules, or an error that names PIL."""
    try:
        from PIL import Image, ImageEnhance, ImageFilter, ImageOps
    except ImportError as e:
        raise RuntimeError(
            "training images need PIL (Pillow), which is not installed: "
            "the augmentations and the LR downscale are PIL's") from e
    return Image, ImageEnhance, ImageFilter, ImageOps


def load_render_mask_pil(render_path: str, mask_path: str):
    """(RGB image, L mask) as PIL images: the training path's loader
    (``surs_tpu/data/image.py:22``). ``datasets.load_render_mask`` gives
    the same pixels as uint8 arrays for the eval path."""
    Image = _pil()[0]
    return (Image.open(render_path).convert("RGB"),
            Image.open(mask_path).convert("L"))


def apply_color_jitter(img, rng: np.random.Generator,
                       brightness: float = 0.0, contrast: float = 0.0,
                       saturation: float = 0.0, hue: float = 0.0):
    """torchvision-style ColorJitter (factor ranges [max(0, 1 - x),
    1 + x]), applied in an order drawn from ``rng``.

    The JAX package's enhance closures read their factor when they run,
    so brightness, contrast and saturation all take the LAST factor drawn
    (``surs_tpu/data/image.py:36-43``); the port applies that factor on
    purpose, so that one seed gives the same image (ROADMAP.md C4)."""
    Image, ImageEnhance = _pil()[:2]
    enhancers, factor = [], None
    for amount, enhancer in ((brightness, ImageEnhance.Brightness),
                             (contrast, ImageEnhance.Contrast),
                             (saturation, ImageEnhance.Color)):
        if amount > 0:
            factor = rng.uniform(max(0.0, 1 - amount), 1 + amount)
            enhancers.append(enhancer)
    ops = [lambda im, e=e: e(im).enhance(factor) for e in enhancers]
    if hue > 0:
        shift = rng.uniform(-hue, hue)

        def _hue(im):
            hsv = np.asarray(im.convert("HSV")).copy()
            hsv[..., 0] = (hsv[..., 0].astype(np.int32)
                           + int(shift * 255)) % 256
            return Image.fromarray(hsv, "HSV").convert("RGB")
        ops.append(_hue)
    for i in rng.permutation(len(ops)):
        img = ops[i](img)
    return img


def process_render(render, mask, load_size: int, is_train: bool,
                   aug: Optional[AugParams],
                   rng: Optional[np.random.Generator] = None,
                   aug_bri: float = 0.0, aug_con: float = 0.0,
                   aug_sat: float = 0.0, aug_hue: float = 0.0,
                   aug_blur: float = 0.0
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One HR render (PIL RGB image) and its mask (PIL L image) ->
    (img_HR [S, S, 3], img_LR [S/2, S/2, 3], mask_HR [S, S, 1], mask_LR
    [S/2, S/2, 1]) float32, S = load_size, images in [-1, 1] and
    mask-multiplied. ``is_train`` applies ``aug`` and, with ``rng``, the
    photometric augmentations."""
    Image, _, ImageFilter, ImageOps = _pil()
    aug = aug or AugParams()
    if is_train:
        pad_size = int(0.1 * load_size)
        render = ImageOps.expand(render, pad_size, fill=0)
        mask = ImageOps.expand(mask, pad_size, fill=0)

        w, h = render.size
        th = tw = load_size

        if aug.flip:
            render = ImageOps.mirror(render)
            mask = ImageOps.mirror(mask)
        if aug.scale != 1.0:
            w = int(aug.scale * w)
            h = int(aug.scale * h)
            render = render.resize((w, h), Image.BILINEAR)
            mask = mask.resize((w, h), Image.NEAREST)

        x1 = int(round((w - tw) / 2.0)) + aug.dx
        y1 = int(round((h - th) / 2.0)) + aug.dy
        render = render.crop((x1, y1, x1 + tw, y1 + th))
        mask = mask.crop((x1, y1, x1 + tw, y1 + th))

        if rng is not None and (aug_bri or aug_con or aug_sat or aug_hue):
            render = apply_color_jitter(render, rng, aug_bri, aug_con,
                                        aug_sat, aug_hue)
        if rng is not None and aug_blur > 1e-5:
            render = render.filter(
                ImageFilter.GaussianBlur(rng.uniform(0, aug_blur)))

    mask_lr = mask.resize(tuple(x // 2 for x in mask.size), Image.NEAREST)
    render_lr = render.resize(tuple(x // 2 for x in render.size),
                              Image.BICUBIC)

    def to_np(img_rgb, img_mask):
        arr = np.asarray(img_rgb, dtype=np.float32) / 255.0
        arr = (arr - 0.5) / 0.5
        m = (np.asarray(img_mask, dtype=np.float32) / 255.0)[..., None]
        return arr * m, m

    img_hr, mask_hr = to_np(render, mask)
    img_lr, mask_lr = to_np(render_lr, mask_lr)
    return img_hr, img_lr, mask_hr, mask_lr
