"""The training step (counterpart of ``surs_tpu/train/step.py``).

A step is forward, loss, backward and one optimizer update on the
model's float32 parameters, in place. ``TrainState`` carries the step
count beside the model and the optimizer.

batch keys: images_lr, images_hr (float32 in [-1, 1], or uint8 in the
wire format of ``train/loop.py:batch_host_arrays``), points_lr,
points_hr [B, 3, N], calibs [B, 4, 4], labels_lr (displacement) and
labels_hr (occupancy) [B, N, 1].
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch

from ..models.surs_net import SuRSNet


def denormalize_images(batch: Dict) -> Dict:
    """uint8 images back to [-1, 1]: (k - 127) / 127, exact at -1, 0
    and +1."""
    out = dict(batch)
    for k in ("images_lr", "images_hr"):
        if out[k].dtype == torch.uint8:
            out[k] = (out[k].float() - 127.0) / 127.0
    return out


@dataclass
class TrainState:
    step: int
    model: SuRSNet
    optimizer: torch.optim.Optimizer


def create_train_state(model: SuRSNet, optimizer) -> TrainState:
    return TrainState(step=0, model=model.train(), optimizer=optimizer)


def train_loss(model: SuRSNet, batch: Dict
               ) -> Tuple[torch.Tensor, Tuple[Dict, torch.Tensor,
                                              torch.Tensor]]:
    """The plain loss: the model's training forward.
    -> (total, (errors, pred_hr, pred_lr))."""
    pred_hr, total, pred_lr, errors = model(train=True, **batch)
    return total, (errors, pred_hr, pred_lr)


def make_step(loss_fn: Callable) -> Callable:
    """``step(state, batch) -> (state, metrics)`` around
    ``loss_fn(model, batch) -> (total, (errors, pred_hr, pred_lr))``;
    metrics hold the detached errors, ``pred_hr`` and ``pred_lr``."""

    def step(state: TrainState, batch: Dict):
        batch = denormalize_images(batch)
        state.optimizer.zero_grad(set_to_none=True)
        total, (errors, pred_hr, pred_lr) = loss_fn(state.model, batch)
        total.backward()
        state.optimizer.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in errors.items()}
        metrics["pred_hr"] = pred_hr.detach()
        metrics["pred_lr"] = pred_lr.detach()
        return state, metrics

    return step


def make_train_step(model: SuRSNet, optimizer) -> Callable:
    """The plain step: autograd through the model's whole forward; a
    batch-norm model's running statistics move once a step, in the
    forward (also under ``remat_encoder``).
    ``model`` and ``optimizer`` are those the state will carry; the
    arguments keep the JAX signature."""
    del model, optimizer
    return make_step(train_loss)


def make_eval_loss_step(model: SuRSNet) -> Callable:
    """Loss-only forward for validation (eval encode: last stack only;
    batch norms normalise with their running statistics and leave them
    alone): ``step(batch) -> errors``."""

    @torch.no_grad()
    def step(batch: Dict) -> Dict:
        batch = denormalize_images(batch)
        _, _, _, errors = model(train=False, **batch)
        return errors

    return step
