"""The training step (counterpart of ``surs_tpu/train/step.py``).

A step is forward, loss, backward and one optimizer update on the
model's float32 parameters, in place. ``TrainState`` carries the step
count beside the model and the optimizer.

batch keys: images_lr, images_hr (float32 in [-1, 1], or uint8 in the
wire format of ``train/loop.py:batch_host_arrays``), points_lr,
points_hr [B, 3, N], calibs [B, 4, 4], labels_lr (displacement) and
labels_hr (occupancy) [B, N, 1].

Data parallelism (``surs_tpu/train/step.py:1-7``, held by
``tests/test_parallel.py:24-46``): give ``make_train_step`` a
``parallel.Mesh`` and each rank the state replicated
(``parallel.replicate_tree``) and its rows of the batch
(``parallel.shard_batch``; the batch must divide by the ``data`` axis).
The step then equals the single-device step on the whole batch: every
loss term is a mean over equal shards, so the gradients are the mean of
the ranks' gradients, all-reduced over ``data`` (every rank applies the
same update); a batch norm takes its statistics over the
global batch (``models/layers.py:sync_batch_stats``); the metrics' losses
are the global means, ``pred_hr`` / ``pred_lr`` this rank's rows.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch

from ..models.layers import sync_batch_stats
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


def make_step(loss_fn: Callable, mesh=None) -> Callable:
    """``step(state, batch) -> (state, metrics)`` around
    ``loss_fn(model, batch) -> (total, (errors, pred_hr, pred_lr))``;
    metrics hold the detached errors, ``pred_hr`` and ``pred_lr``.
    ``mesh``: data parallelism over its ``data`` axis (module doc)."""
    comm = None
    if mesh is not None:
        from ..parallel.mesh import DATA_AXIS
        comm = mesh.comm(DATA_AXIS)

    def step(state: TrainState, batch: Dict):
        batch = denormalize_images(batch)
        state.optimizer.zero_grad(set_to_none=True)
        with (contextlib.nullcontext() if comm is None
              else sync_batch_stats(state.model, comm)):
            total, (errors, pred_hr, pred_lr) = loss_fn(state.model, batch)
            total.backward()
        if comm is not None:
            errors = dict(zip(errors, _mean_over(
                comm, torch.stack([v.detach() for v in errors.values()]))))
            _average_gradients(state.model, comm)
        state.optimizer.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in errors.items()}
        metrics["pred_hr"] = pred_hr.detach()
        metrics["pred_lr"] = pred_lr.detach()
        return state, metrics

    return step


def _mean_over(comm, t: torch.Tensor) -> torch.Tensor:
    return comm.all_reduce_sum(t) / comm.size


def _average_gradients(model: torch.nn.Module, comm) -> None:
    """Every parameter's gradient -> the mean over the ranks, through one
    flat buffer."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    if not grads:
        return
    flat = _mean_over(comm, torch.cat([g.reshape(-1) for g in grads]))
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def make_train_step(model: SuRSNet, optimizer, mesh=None) -> Callable:
    """The plain step: autograd through the model's whole forward; a
    batch-norm model's running statistics move once a step, in the
    forward (also under ``remat_encoder``).
    ``model`` and ``optimizer`` are those the state will carry; the
    arguments keep the JAX signature. ``mesh``: the data-parallel step
    (module doc)."""
    del model, optimizer
    return make_step(train_loss, mesh)


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
