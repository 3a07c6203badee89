"""Train-state checkpoints (counterpart of
``surs_tpu/train/checkpoint.py``).

``torch.save`` of the model's state_dict (a batch-norm model's running
statistics included), the optimizer's state_dict and the step, under the
reference's names:
``{checkpoints_path}/{name}/netG_epoch_{N}`` and ``netG_latest``. The
full train state is saved, so a resume is exact. ``load_model_state``
reads such a file, or a reference ``torch.save(netG.state_dict())``
file, for the trainer's resume and the service's ``load_netG``. Reading
the JAX package's orbax directories is not ported (ROADMAP.md A17).
"""

from __future__ import annotations

import os
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
            os.replace(tmp, path)

    def restore(self, state: TrainState, epoch: Optional[int] = None
                ) -> TrainState:
        """Load into ``state``'s model and optimizer in place;
        epoch=None reads netG_latest (the reference's resume_epoch < 0
        convention)."""
        device = next(state.model.parameters()).device
        path = self.path(epoch)
        model_state, blob = load_model_state(path, device)
        if blob is None:
            raise ValueError(f"{path}: a bare state dict, not a train state")
        state.model.load_state_dict(model_state)
        state.optimizer.load_state_dict(blob["optimizer"])
        state.step = int(blob["step"])
        return state

    def exists(self, epoch: Optional[int] = None) -> bool:
        return os.path.isfile(self.path(epoch))
