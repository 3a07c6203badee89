"""Loss functions and regularizers (counterpart of
``surs_tpu/train/losses.py``).

The four operative SuRS losses live in the model forward
(models/surs_net.py:surs_loss). This module carries the auxiliary loss
surface as plain tensor functions: masked/weighted BCE and MSE, the
WGAN-GP gradient penalty and the mse/l1/bce helpers of the color branch.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def mse(pred, target):
    return torch.mean((pred - target) ** 2)


def l1(pred, target):
    return torch.mean(torch.abs(pred - target))


def bce(pred, target, eps: float = 1e-7):
    p = torch.clamp(pred, eps, 1.0 - eps)
    return -torch.mean(target * torch.log(p) + (1 - target) * torch.log(1 - p))


def _masked_mean(loss, mask: Optional[torch.Tensor]):
    if mask is None:
        return torch.mean(loss)
    loss = loss * mask
    return torch.sum(loss) / torch.clamp(torch.sum(mask), min=1.0)


def custom_bce(pred, target, gamma: float = 0.5,
               mask: Optional[torch.Tensor] = None, eps: float = 1e-7):
    """Class-weighted BCE: gamma on positives, (1-gamma) on negatives,
    optionally masked (reference CustomBCELoss semantics)."""
    p = torch.clamp(pred, eps, 1.0 - eps)
    loss = -(gamma * target * torch.log(p)
             + (1 - gamma) * (1 - target) * torch.log(1 - p))
    return _masked_mean(loss, mask)


def custom_mse(pred, target, gamma: float = 0.5,
               mask: Optional[torch.Tensor] = None):
    """Class-weighted MSE (reference CustomMSELoss semantics)."""
    w = gamma * target + (1 - gamma) * (1 - target)
    return _masked_mean(w * (pred - target) ** 2, mask)


COLOR_LOSSES = {"mse": mse, "l1": l1, "bce": bce}


def gradient_penalty(disc_fn: Callable, real: torch.Tensor,
                     fake: torch.Tensor, generator: torch.Generator,
                     lambda_gp: float = 10.0) -> torch.Tensor:
    """WGAN-GP penalty E[(||grad D(x_hat)||_2 - 1)^2] on interpolates
    x_hat = alpha * real + (1 - alpha) * fake, one uniform alpha per
    sample drawn from ``generator``. Differentiable (create_graph)."""
    alpha = torch.rand((real.shape[0],) + (1,) * (real.dim() - 1),
                       generator=generator, device=generator.device,
                       dtype=real.dtype).to(real.device)
    inter = (alpha * real + (1 - alpha) * fake).requires_grad_(True)
    grads, = torch.autograd.grad(disc_fn(inter).sum(), inter,
                                 create_graph=True)
    norms = torch.sqrt(torch.sum(grads.reshape(grads.shape[0], -1) ** 2,
                                 dim=1) + 1e-16)
    return lambda_gp * torch.mean((norms - 1.0) ** 2)
