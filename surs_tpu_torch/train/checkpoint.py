"""Train-state checkpoints (counterpart of
``surs_tpu/train/checkpoint.py``).

``torch.save`` of the model's state_dict (a batch-norm model's running
statistics included), the optimizer's state_dict and the step, under the
reference's names:
``{checkpoints_path}/{name}/netG_epoch_{N}`` and ``netG_latest``. The
full train state is saved, so a resume is exact. ``load_model_state``
reads such a file, or a reference ``torch.save(netG.state_dict())``
file, for the trainer's resume and the service's ``load_netG``. Where a
``netG_*`` path is a directory, it is the JAX package's orbax train
state, and ``restore`` reads it through ``compat/orbax_import.py``: a
training run started in JAX goes on from the same weights, moments,
learning rate and step. ``save`` replaces such a directory with the
port's file, as the JAX package overwrites its checkpoints.
"""

from __future__ import annotations

import os
import shutil
from collections.abc import Mapping
from typing import Optional, Tuple

import torch

from .step import TrainState


def load_model_state(path: str, map_location="cpu"
                     ) -> Tuple[Mapping, Optional[dict]]:
    """A checkpoint file -> (the model's state_dict, the train-state
    blob or None). A port ``netG_*`` file is a blob ``{"step", "model",
    "optimizer"}``; any other mapping is taken as a bare state dict (the
    reference's ``torch.save(netG.state_dict())``)."""
    blob = torch.load(path, map_location=map_location, weights_only=True)
    if not isinstance(blob, Mapping):
        raise ValueError(f"{path}: not a state dict or a train state")
    if isinstance(blob.get("model"), Mapping) and "step" in blob:
        return blob["model"], blob
    return blob, None


class CheckpointManager:
    def __init__(self, checkpoints_path: str, name: str):
        self.root = os.path.abspath(os.path.join(checkpoints_path, name))
        os.makedirs(self.root, exist_ok=True)

    def path(self, epoch: Optional[int] = None) -> str:
        tag = "netG_latest" if epoch is None else f"netG_epoch_{epoch}"
        return os.path.join(self.root, tag)

    def save(self, state: TrainState, epoch: int, latest: bool = True
             ) -> None:
        blob = {"step": state.step, "model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict()}
        targets = [self.path(epoch)] + ([self.path()] if latest else [])
        for path in targets:
            tmp = f"{path}.{os.getpid()}.tmp"
            torch.save(blob, tmp)
            if os.path.isdir(path):          # a JAX train state's
                shutil.rmtree(path)
            os.replace(tmp, path)

    def restore(self, state: TrainState, epoch: Optional[int] = None
                ) -> TrainState:
        """Load into ``state``'s model and optimizer in place;
        epoch=None reads netG_latest (the reference's resume_epoch < 0
        convention). A directory there is a JAX train state (orbax)."""
        path = self.path(epoch)
        if os.path.isdir(path):
            from ..compat.orbax_import import restore_train_state
            restore_train_state(path, state)
            return state
        device = next(state.model.parameters()).device
        model_state, blob = load_model_state(path, device)
        if blob is None:
            raise ValueError(f"{path}: a bare state dict, not a train state")
        state.model.load_state_dict(model_state)
        state.optimizer.load_state_dict(blob["optimizer"])
        state.step = int(blob["step"])
        return state

    def exists(self, epoch: Optional[int] = None) -> bool:
        return os.path.exists(self.path(epoch))
