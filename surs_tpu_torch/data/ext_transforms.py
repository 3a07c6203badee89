"""Extended augmentations (the port's copy of
``surs_tpu/data/ext_transforms.py``): vertical flip, PCA ("AlexNet-style")
lighting jitter and a random Gaussian blur, as functions over PIL or
numpy images that draw from an ``np.random.Generator`` in the JAX
package's order. The PCA lighting strength is ``--aug_alstd``. PIL is
imported inside the functions that need it (``image._pil``).
"""

from __future__ import annotations

import numpy as np

from .image import _pil

# ImageNet RGB covariance eigen-decomposition (Krizhevsky et al. 2012)
_EIGVAL = np.array([0.2175, 0.0188, 0.0045])
_EIGVEC = np.array([
    [-0.5675, 0.7192, 0.4009],
    [-0.5808, -0.0045, -0.8140],
    [-0.5836, -0.6948, 0.4203],
])


def random_vertical_flip(img, rng: np.random.Generator, p: float = 0.5):
    ImageOps = _pil()[3]
    return ImageOps.flip(img) if rng.random() < p else img


def pca_lighting(img: np.ndarray, rng: np.random.Generator,
                 alphastd: float = 0.1) -> np.ndarray:
    """img float [H, W, 3] in [0, 1] -> lighting-jittered copy."""
    if alphastd <= 0:
        return img
    alpha = rng.normal(0.0, alphastd, 3)
    shift = _EIGVEC @ (alpha * _EIGVAL)
    return np.clip(img + shift[None, None, :], 0.0, 1.0)


def random_gaussian_blur(img, rng: np.random.Generator,
                         max_radius: float = 2.0):
    if max_radius <= 1e-5:
        return img
    ImageFilter = _pil()[2]
    return img.filter(ImageFilter.GaussianBlur(rng.uniform(0, max_radius)))
