"""The synthetic benchmark subject: a capsule humanoid (the port's copy
of ``surs_tpu/utils/synth.py``).

The capsule table, ``humanoid_variant`` and ``humanoid_sdf_np`` are
numpy and copied verbatim; ``humanoid_sdf`` and ``humanoid_volume`` are
the torch counterparts of ``humanoid_sdf_jnp`` and ``humanoid_volume``
and build the field on a device (CUDA unless named). The subject stands
about 1.7 units tall, y up, in ~[-0.7, 0.85]; its 512^3 isosurface has
the active-cell count of a clothed human, the framework's target.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device

# (ax, ay, az, bx, by, bz, r) capsules, y up, subject in ~[-0.7, 0.85]
_CAPSULES = np.array([
    (0, 0.20, 0, 0, 0.55, 0, 0.17),          # torso
    (0, 0.60, 0, 0, 0.66, 0, 0.065),          # neck
    (0, 0.74, 0, 0, 0.76, 0, 0.115),          # head
    (+0.17, 0.52, 0, +0.40, 0.24, 0.05, 0.055),   # arms
    (-0.17, 0.52, 0, -0.40, 0.24, 0.05, 0.055),
    (+0.40, 0.24, 0.05, +0.44, 0.02, 0.12, 0.05),
    (-0.40, 0.24, 0.05, -0.44, 0.02, 0.12, 0.05),
    (+0.09, 0.16, 0, +0.12, -0.32, 0.02, 0.075),  # legs
    (-0.09, 0.16, 0, -0.12, -0.32, 0.02, 0.075),
    (+0.12, -0.32, 0.02, +0.13, -0.62, 0.0, 0.06),
    (-0.12, -0.32, 0.02, -0.13, -0.62, 0.0, 0.06),
    (+0.13, -0.62, 0.0, +0.13, -0.64, 0.12, 0.05),  # feet
    (-0.13, -0.62, 0.0, -0.13, -0.64, 0.12, 0.05),
], np.float32)

def humanoid_sdf(px: torch.Tensor, py: torch.Tensor, pz: torch.Tensor,
                 detail: float = 0.0) -> torch.Tensor:
    """Signed distance of the capsule humanoid at points (px, py, pz)
    (component-wise 1-D tensors, float32): ``humanoid_sdf_jnp``'s
    arithmetic in its order."""
    d = torch.full_like(px, 1e9)
    for ax, ay, az, bx, by, bz, r in _CAPSULES:
        abx, aby, abz = bx - ax, by - ay, bz - az
        den = abx * abx + aby * aby + abz * abz
        apx, apy, apz = px - ax, py - ay, pz - az
        t = torch.clamp((apx * abx + apy * aby + apz * abz) / den, 0.0, 1.0)
        dx = apx - t * abx
        dy = apy - t * aby
        dz = apz - t * abz
        d = torch.minimum(d, torch.sqrt(dx * dx + dy * dy + dz * dz) - r)
    if detail > 0:
        d = d - detail * (torch.sin(31.0 * px) * torch.sin(29.0 * py)
                          * torch.sin(33.0 * pz))
    return d


def humanoid_variant(variant: int):
    """Deterministic parameterized subject family for multi-subject
    training/generalization runs (benchmarks/generalization_demo.py).

    Returns (capsules [K, 7], detail_amp, freqs (3,)). Variant 0 is the
    canonical skeleton; others jitter pose (arm/leg endpoints), limb
    radii, global height and the HR detail field — distinct enough that
    a model must generalize across body shape, not memorize one.
    """
    caps = _CAPSULES.copy()
    if variant == 0:
        return caps, 0.012, np.array([31.0, 29.0, 33.0], np.float32)
    rng = np.random.default_rng(7000 + variant)
    # global scale (height / girth)
    sy = 1.0 + rng.uniform(-0.08, 0.10)
    sxz = 1.0 + rng.uniform(-0.08, 0.08)
    caps[:, [1, 4]] *= sy
    caps[:, [0, 3]] *= sxz
    caps[:, [2, 5]] *= sxz
    caps[:, 6] *= 1.0 + rng.uniform(-0.12, 0.15)
    # arm pose: swing the elbow/hand chain out/in and fore/aft
    swing = rng.uniform(-0.08, 0.10)
    fore = rng.uniform(-0.10, 0.10)
    for i, s in ((3, 1.0), (4, -1.0)):          # upper arms (b endpoint)
        caps[i, 3] += s * swing
        caps[i, 5] += fore
    for i, s in ((5, 1.0), (6, -1.0)):          # forearms (both ends)
        caps[i, [0, 3]] += s * swing
        caps[i, [2, 5]] += fore
    # leg stance width
    stance = rng.uniform(-0.03, 0.05)
    for i, s in ((7, 1.0), (8, -1.0), (9, 1.0), (10, -1.0),
                 (11, 1.0), (12, -1.0)):
        caps[i, [0, 3]] += s * stance
    # per-limb endpoint jitter
    caps[:, :6] += rng.uniform(-0.015, 0.015,
                               caps[:, :6].shape).astype(np.float32)
    detail = float(rng.uniform(0.006, 0.018))
    freqs = rng.uniform(21.0, 41.0, 3).astype(np.float32)
    return caps, detail, freqs


def humanoid_sdf_np(p: np.ndarray, capsules: np.ndarray = None,
                    detail: float = 0.0,
                    freqs=(31.0, 29.0, 33.0)) -> np.ndarray:
    """Numpy capsule-humanoid SDF at points p [N, 3] (host-side label
    generation / GT meshing for the synthetic subject family)."""
    caps = _CAPSULES if capsules is None else np.asarray(capsules)
    d = np.full(p.shape[0], 1e9, np.float32)
    for ax, ay, az, bx, by, bz, r in caps:
        a = np.array([ax, ay, az], np.float32)
        ab = np.array([bx - ax, by - ay, bz - az], np.float32)
        ap = p - a
        t = np.clip((ap @ ab) / (ab @ ab), 0.0, 1.0)
        d = np.minimum(d, np.linalg.norm(
            ap - t[:, None] * ab[None, :], axis=-1) - r)
    if detail > 0:
        fx, fy, fz = freqs
        d = d - detail * (np.sin(fx * p[:, 0]) * np.sin(fy * p[:, 1])
                          * np.sin(fz * p[:, 2]))
    return d


def humanoid_volume(resolution: int, detail: float = 0.012,
                    lo: float = -1.0, hi: float = 1.0,
                    device=None) -> torch.Tensor:
    """[R, R, R] occupancy-style volume (0.5 + inside-distance) on
    ``device`` (CUDA unless named), axes (x, y, z) over ``linspace(lo,
    hi, R)``; isosurface at level 0.5."""
    R = resolution
    g = torch.linspace(lo, hi, R, dtype=torch.float32,
                       device=resolve_device(device))
    px = g.repeat_interleave(R * R)
    py = g.repeat_interleave(R).repeat(R)
    pz = g.repeat(R * R)
    d = humanoid_sdf(px, py, pz, detail)
    return (0.5 - d).reshape(R, R, R)
