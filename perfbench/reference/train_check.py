"""The output check of the training cells: the plain model in float32
(TF32 off) takes the first three steps from the weights and batch the
benchmark made (the published loss: stack-averaged MSE of the coarse
and fine occupancy, L1 of the super-resolved image, the displacement
MSE; Adam with optax's rule), and the program's readings are held to
its: each step's loss, the first gradient by leaf, and each leaf's
change after the three steps. The control takes the same steps in a
lower precision.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from . import model as ref

LOSS_WEIGHTS = (1.0, 1.0, 1.0, 1.0)


def batch_tensors(items: Sequence[Dict], device) -> Dict[str, torch.Tensor]:
    """Items in the dataset's format -> the step's tensors: images as the
    program ships them (k = round(127 x) + 127, back as (k - 127) / 127),
    points [B, 3, N], labels [B, N, 1]."""
    def stack(key):
        return np.stack([it[key] for it in items])

    def img(key):
        k = np.clip(np.rint(stack(key) * 127.0) + 127.0, 0, 254)
        t = torch.tensor(k.astype(np.float32), device=device)
        return (t - 127.0) / 127.0

    return {"images_lr": img("img_LR"), "images_hr": img("img_HR"),
            "points_lr": torch.tensor(stack("samples_LR"), device=device),
            "points_hr": torch.tensor(stack("samples_HR"), device=device),
            "calibs": torch.tensor(stack("calib"), device=device),
            "labels_lr": torch.tensor(stack("labels_disp"),
                                      device=device).transpose(1, 2),
            "labels_hr": torch.tensor(stack("labels_HR"),
                                      device=device).transpose(1, 2)}


def loss(p: ref.Params, b: Dict[str, torch.Tensor], num_stack: int,
         load_size: int, z_size: float) -> torch.Tensor:
    img_sr, feats, feat_hr = ref.encode(b["images_lr"], p, num_stack)
    uv_a, z_a, m_a = ref.project(b["points_hr"], b["calibs"], load_size,
                                 z_size)
    uv_b, z_b, m_b = ref.project(b["points_lr"], b["calibs"], load_size,
                                 z_size)
    hr_a, hr_b = ref.sample(feat_hr, uv_a), ref.sample(feat_hr, uv_b)
    preds_lr: List[torch.Tensor] = []
    preds_hr: List[torch.Tensor] = []
    for f in feats:
        xa = torch.cat([ref.sample(f, uv_a), hr_a, z_a], -1)
        lr = m_a[..., None] * ref.mlp(xa, p, "mlp_lr")
        xb = torch.cat([ref.sample(f, uv_b), hr_b, z_b, lr], -1)
        preds_lr.append(lr)
        preds_hr.append(m_b[..., None] * ref.mlp(xb, p, "mlp_hr"))
    e1 = sum(torch.mean((x - b["labels_hr"]) ** 2) for x in preds_lr) \
        / len(preds_lr)
    e2 = sum(torch.mean((x - b["labels_lr"]) ** 2) for x in preds_hr) \
        / len(preds_hr)
    e3 = torch.mean(torch.abs(img_sr.permute(0, 2, 3, 1) - b["images_hr"]))
    disp = (b["labels_lr"] - b["labels_hr"]) - (preds_hr[-1] - preds_lr[-1])
    e4 = torch.mean(disp ** 2)
    w1, w2, w3, w4 = LOSS_WEIGHTS
    return w1 * e1 + w2 * e2 + w3 * e3 + w4 * e4


def reference_steps(params: ref.Params, batch: Dict[str, torch.Tensor],
                    cfg, steps: int = 3, mode: str = "float32") -> Dict:
    """``steps`` plain Adam steps (optax's rule) from ``params``; returns
    {"loss": [..], "grad1": {leaf: norm}, "change": {leaf: norm}}."""
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2, eps, lr = cfg.beta1, cfg.beta2, cfg.epsilon, cfg.learning_rate
    out: Dict = {"loss": []}
    with ref.precision(mode):
        for step in range(1, steps + 1):
            total = loss(p, batch, cfg.num_stack_lr, cfg.loadSize,
                         cfg.z_size)
            grads = torch.autograd.grad(total, list(p.values()),
                                        allow_unused=True)
            out["loss"].append(float(total.detach()))
            with torch.no_grad():
                if step == 1:
                    out["grad1"] = {k: float(g.norm()) if g is not None
                                    else 0.0 for k, g in zip(p, grads)}
                c = torch.tensor(float(step))
                for (k, v), g in zip(p.items(), grads):
                    if g is None:
                        continue
                    mu[k] = (1 - b1) * g + b1 * mu[k]
                    nu[k] = (1 - b2) * (g * g) + b2 * nu[k]
                    mh = mu[k] / (1 - torch.tensor(b1) ** c)
                    nh = nu[k] / (1 - torch.tensor(b2) ** c)
                    v.add_(mh / (torch.sqrt(nh) + eps) * (-lr))
            del total, grads
    with torch.no_grad():
        out["change"] = {k: float((p[k] - params[k]).norm()) for k in p}
    return out


def leaf_gaps(got: Dict[str, float], want: Dict[str, float],
              leaves: Sequence[str]) -> Dict[str, float]:
    """Each leaf's gap of norms against the larger of its own reference
    norm and the median leaf's."""
    med = float(np.median([want[k] for k in leaves])) if leaves else 0.0
    return {k: abs(got.get(k, 0.0) - want[k]) / max(want[k], med, 1e-30)
            for k in leaves}


def leaf_gap(got: Dict[str, float], want: Dict[str, float],
             leaves: Sequence[str]) -> float:
    """The worst leaf's gap of norms."""
    return max(leaf_gaps(got, want, leaves).values(), default=0.0)


def worst_leaves(got: Dict, want: Dict, key: str, n: int = 6):
    """The ``n`` leaves with the widest gaps of ``key`` ("grad1" or
    "change"): [leaf, gap, program norm, reference norm]."""
    gaps = leaf_gaps(got.get(key, {}), want[key], list(want[key]))
    top = sorted(gaps, key=lambda k: -gaps[k])[:n]
    return [[k, gaps[k], got.get(key, {}).get(k, 0.0), want[key][k]]
            for k in top]


def compare(got: Dict, want: Dict) -> Dict[str, float]:
    """``loss_gap``: the worst of the first three steps' relative loss
    gaps; ``grad_gap`` / ``grad_gap_med``: the first gradient's worst and
    median leaf; ``change_gap`` / ``change_gap_med``: the change after
    three steps, worst and median leaf, without the leaves whose
    reference gradient is under a thousandth of the median leaf's
    (round-off moves those under Adam). The worst leaves are early SR
    biases whose loss has a kink at the first step (leaky ReLU at the
    exactly-zero pre-activations of the masked background under zero
    biases), so their gradient depends on which side rounding takes:
    the cells compare the median leaf's."""
    n = min(len(got["loss"]), len(want["loss"]))
    loss_gap = max([abs(got["loss"][i] - want["loss"][i])
                    / abs(want["loss"][i]) for i in range(n)] or [np.inf])
    if n < len(want["loss"]):
        loss_gap = float("inf")
    leaves = list(want["grad1"])
    med = float(np.median([want["grad1"][k] for k in leaves]))
    moving = [k for k in leaves if want["grad1"][k] >= 1e-3 * med]
    g = leaf_gaps(got.get("grad1", {}), want["grad1"], leaves)
    c = leaf_gaps(got.get("change", {}), want["change"], moving)
    return {"loss_gap": float(loss_gap),
            "grad_gap": max(g.values(), default=0.0),
            "grad_gap_med": float(np.median(list(g.values()))) if g
            else 0.0,
            "change_gap": max(c.values(), default=0.0),
            "change_gap_med": float(np.median(list(c.values()))) if c
            else 0.0}
