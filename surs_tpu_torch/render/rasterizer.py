"""Z-buffer triangle rasterizer in torch (counterpart of
``surs_tpu/render/rasterizer.py``), on the tensors' device.

The JAX package's algorithm and semantics:
  1. per-face candidate pixels: a P x P patch anchored at each face's
     bbox corner (faces larger than P pixels must be subdivided first);
  2. barycentric inside-tests (the 1e-6 and 1e-12 guards) and depth
     interpolation for all F * P * P candidates;
  3. the winner of each pixel by two scatter-mins: the front-most depth,
     then the smallest face id among the candidates whose depth equals
     it exactly;
  4. the attributes interpolated from the winning face, its barycentric
     weights recomputed at the pixel.

The scatters are ``scatter_reduce_(..., "amin")`` into ``res * res + 1``
slots: the last slot takes the candidates outside the face or the image,
which JAX's ``mode="drop"`` drops. The depth of every candidate is
computed once and the same tensor feeds both passes, so the exact-equality
tie-break of pass 2 sees the values pass 1 reduced.

Depth convention: the camera looks down +z in uv space; the SMALLEST z
wins. Off the mask the image is 0 and the depth 1e9.
"""

from __future__ import annotations

from typing import Tuple

import torch

_BIG = 1e9
_NO_FACE = 2 ** 30


def rasterize(verts_uv: torch.Tensor, faces: torch.Tensor,
              attrs: torch.Tensor, res: int = 512, patch: int = 16
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rasterize triangles to an attribute image.

    verts_uv: [V, 3] float32, x, y in [-1, 1] (y down), z depth.
    faces:    [F, 3] integer.
    attrs:    [V, A] float32 per-vertex attributes to interpolate.
    Returns (image [res, res, A], mask [res, res] bool, depth [res, res]).
    """
    dev = verts_uv.device
    faces = faces.long()
    F = faces.shape[0]
    P = patch
    if F == 0:
        return (torch.zeros((res, res, attrs.shape[1]), dtype=attrs.dtype,
                            device=dev),
                torch.zeros((res, res), dtype=torch.bool, device=dev),
                torch.full((res, res), _BIG, dtype=torch.float32,
                           device=dev))

    # uv -> continuous pixel coords (align_corners=True: u=-1 -> 0,
    # u=1 -> res-1)
    px = (verts_uv[:, 0] + 1.0) * 0.5 * (res - 1)
    py = (verts_uv[:, 1] + 1.0) * 0.5 * (res - 1)
    pz = verts_uv[:, 2]
    pv = torch.stack([px, py], dim=1)                     # [V, 2]

    tri = pv[faces]                                       # [F, 3, 2]
    tz = pz[faces]                                        # [F, 3]

    x0 = torch.floor(tri[:, :, 0].amin(dim=1)).long()
    y0 = torch.floor(tri[:, :, 1].amin(dim=1)).long()

    offs = torch.arange(P, device=dev)
    cx = x0[:, None, None] + offs[None, None, :]          # [F, P, P]
    cy = y0[:, None, None] + offs[None, :, None]

    ax = tri[:, 0, 0][:, None, None]
    ay = tri[:, 0, 1][:, None, None]
    bx = tri[:, 1, 0][:, None, None]
    by = tri[:, 1, 1][:, None, None]
    ox = tri[:, 2, 0][:, None, None]
    oy = tri[:, 2, 1][:, None, None]

    fx = cx.float()
    fy = cy.float()
    det = (bx - ax) * (oy - ay) - (ox - ax) * (by - ay)
    det_safe = torch.where(det.abs() < 1e-12, 1e-12, det)
    l1 = ((fx - ax) * (oy - ay) - (ox - ax) * (fy - ay)) / det_safe
    l2 = ((bx - ax) * (fy - ay) - (fx - ax) * (by - ay)) / det_safe
    l0 = 1.0 - l1 - l2
    inside = ((l0 >= -1e-6) & (l1 >= -1e-6) & (l2 >= -1e-6)
              & (det.abs() > 1e-12)
              & (cx >= 0) & (cx < res) & (cy >= 0) & (cy < res))

    z = (l0 * tz[:, 0][:, None, None] + l1 * tz[:, 1][:, None, None]
         + l2 * tz[:, 2][:, None, None])
    z_f = torch.where(inside, z, _BIG).reshape(-1)
    del fx, fy, l0, l1, l2, z
    # candidates outside go to the extra slot res * res
    pix_f = torch.where(inside, cy * res + cx, res * res).reshape(-1)
    del cx, cy, inside

    # pass 1: front-most depth per pixel
    zbuf = torch.full((res * res + 1,), _BIG, dtype=torch.float32,
                      device=dev)
    zbuf.scatter_reduce_(0, pix_f, z_f, "amin", include_self=True)
    # pass 2: among the exact depth winners, the smallest face id
    fid = torch.arange(F, device=dev).repeat_interleave(P * P)
    is_win = (z_f <= zbuf[pix_f]) & (z_f < _BIG)
    fid_masked = torch.where(is_win, fid, _NO_FACE)
    del fid, is_win, z_f
    fbuf = torch.full((res * res + 1,), _NO_FACE, dtype=torch.int64,
                      device=dev)
    fbuf.scatter_reduce_(0, pix_f, fid_masked, "amin", include_self=True)
    fbuf = fbuf[:res * res]
    del pix_f, fid_masked

    mask = (fbuf < _NO_FACE).reshape(res, res)
    win_face = torch.clamp(fbuf, max=F - 1)               # [res*res]

    # per-pixel barycentric recompute against the winning face
    g = torch.arange(res, device=dev, dtype=torch.float32)
    fxg = g.repeat(res)
    fyg = g.repeat_interleave(res)
    wt = tri[win_face]                                    # [res*res, 3, 2]
    wz = tz[win_face]
    wa = attrs[faces[win_face]]                           # [res*res, 3, A]
    axg, ayg = wt[:, 0, 0], wt[:, 0, 1]
    bxg, byg = wt[:, 1, 0], wt[:, 1, 1]
    oxg, oyg = wt[:, 2, 0], wt[:, 2, 1]
    detg = (bxg - axg) * (oyg - ayg) - (oxg - axg) * (byg - ayg)
    detg = torch.where(detg.abs() < 1e-12, 1e-12, detg)
    g1 = ((fxg - axg) * (oyg - ayg) - (oxg - axg) * (fyg - ayg)) / detg
    g2 = ((bxg - axg) * (fyg - ayg) - (fxg - axg) * (byg - ayg)) / detg
    g0 = 1.0 - g1 - g2
    lam = torch.stack([g0, g1, g2], dim=1)                # [res*res, 3]
    img = torch.einsum("pk,pka->pa", lam, wa)
    depth = torch.einsum("pk,pk->p", lam, wz)

    m = mask.reshape(-1, 1).to(img.dtype)
    img = (img * m).reshape(res, res, -1)
    depth = torch.where(mask.reshape(-1), depth, _BIG).reshape(res, res)
    return img, mask, depth
