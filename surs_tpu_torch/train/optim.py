"""Optimizers and the LR schedule (counterpart of
``surs_tpu/train/optim.py``).

The JAX package builds its four optimizers with optax; two of them
compute something else than their ``torch.optim`` namesakes:

  * RMSprop: optax decays the second moment with 0.9 and puts eps inside
    the square root (``g / sqrt(nu + eps)``); torch uses alpha 0.99 and
    eps outside.
  * AMSgrad: optax takes the running max of the bias-corrected second
    moment; ``torch.optim.Adam(amsgrad=True)`` of the uncorrected one.

So this module carries optax's update rules, written in torch, for all
four (SGD with momentum and Adam agree with torch's up to rounding; the
same code keeps the operation order of optax too). ``weight_decay`` adds
``wd * p`` to the gradient before the rule (optax
``add_decayed_weights``). The step count and the moments are float32
state tensors per parameter, saved with ``state_dict``.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import torch

_KINDS = ("SGD", "ADAM", "RMSprop", "AMSgrad")


def _bias_correction(moment, decay: float, count: torch.Tensor):
    # optax: 1 - decay ** count in float32, the division in the moment's
    # precision
    return moment / (1 - torch.tensor(decay, dtype=torch.float32)
                     ** count.float())


class OptaxOptimizer(torch.optim.Optimizer):
    """``kind`` in SGD | ADAM | RMSprop | AMSgrad with optax's rules:

      SGD:     t = g + momentum * t;          u = t (momentum 0: u = g)
      ADAM:    mu, nu moments; u = mu_hat / (sqrt(nu_hat) + eps)
      RMSprop: nu = 0.1 g^2 + 0.9 nu;          u = g * rsqrt(nu + 1e-8)
      AMSgrad: nu_max = max(nu_max, nu_hat);   u = mu_hat / (sqrt(nu_max) + eps)

    then p += (-lr) * u."""

    def __init__(self, params: Iterable, kind: str, lr: float,
                 momentum: float = 0.0, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        if kind not in _KINDS:
            raise ValueError(f"unknown optimizer {kind!r}")
        super().__init__(params, dict(lr=lr, momentum=momentum, betas=betas,
                                      eps=eps, weight_decay=weight_decay))
        self.kind = kind

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            eps, wd = group["eps"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if wd:
                    g = g + wd * p
                u = self._update(self.state[p], g, group["momentum"], b1,
                                 b2, eps)
                p.add_(u * (-group["lr"]))
        return loss

    def _update(self, st, g, momentum, b1, b2, eps):
        kind = self.kind
        if kind == "SGD":
            if not momentum:
                return g
            if "trace" not in st:
                st["trace"] = torch.zeros_like(g)
            st["trace"] = g + momentum * st["trace"]
            return st["trace"]
        if kind == "RMSprop":
            if "nu" not in st:
                st["nu"] = torch.zeros_like(g)
            st["nu"] = (1 - 0.9) * (g * g) + 0.9 * st["nu"]
            return torch.rsqrt(st["nu"] + 1e-8) * g
        if "mu" not in st:
            st["count"] = torch.zeros((), dtype=torch.int32, device=g.device)
            st["mu"] = torch.zeros_like(g)
            st["nu"] = torch.zeros_like(g)
            if kind == "AMSgrad":
                st["nu_max"] = torch.zeros_like(g)
        st["mu"] = (1 - b1) * g + b1 * st["mu"]
        st["nu"] = (1 - b2) * (g * g) + b2 * st["nu"]
        st["count"] = st["count"] + 1
        mu_hat = _bias_correction(st["mu"], b1, st["count"])
        nu_hat = _bias_correction(st["nu"], b2, st["count"])
        if kind == "AMSgrad":
            st["nu_max"] = torch.maximum(st["nu_max"], nu_hat)
            nu_hat = st["nu_max"]
        return mu_hat / (torch.sqrt(nu_hat) + eps)


def make_optimizer(cfg, params: Iterable) -> OptaxOptimizer:
    """The optimizer of a SuRSConfig over ``params``: its
    ``optimizer``, ``learning_rate``, ``momentum`` (SGD), ``beta1``,
    ``beta2`` and ``epsilon`` (ADAM, AMSgrad) and ``weight_decay``.
    RMSprop keeps optax's defaults (decay 0.9, eps 1e-8), as the JAX
    package does."""
    return OptaxOptimizer(params, cfg.optimizer, cfg.learning_rate,
                          momentum=cfg.momentum or 0.0,
                          betas=(cfg.beta1, cfg.beta2), eps=cfg.epsilon,
                          weight_decay=cfg.weight_decay)


def lr_for_epoch(base_lr: float, epoch: int, schedule: Sequence[int],
                 gamma: float) -> float:
    """LR in effect during ``epoch``: the reference multiplies lr by
    gamma at the end of each epoch listed in ``schedule``, so epoch e
    uses base_lr * gamma^|{s in schedule : s < e}|."""
    return base_lr * (gamma ** sum(1 for s in schedule if s < epoch))


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float
                      ) -> torch.optim.Optimizer:
    """Set every parameter group's learning rate."""
    for group in optimizer.param_groups:
        group["lr"] = lr
    return optimizer
