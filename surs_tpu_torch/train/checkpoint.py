"""Train-state checkpoints (counterpart of
``surs_tpu/train/checkpoint.py``).

``torch.save`` of the model's state_dict, the optimizer's state_dict and
the step, under the reference's names:
``{checkpoints_path}/{name}/netG_epoch_{N}`` and ``netG_latest``. The
full train state is saved, so a resume is exact. Reading the JAX
package's orbax directories is not ported (ROADMAP.md A17).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from .step import TrainState


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
        blob = torch.load(self.path(epoch), map_location=device,
                          weights_only=True)
        state.model.load_state_dict(blob["model"])
        state.optimizer.load_state_dict(blob["optimizer"])
        state.step = int(blob["step"])
        return state

    def exists(self, epoch: Optional[int] = None) -> bool:
        return os.path.isfile(self.path(epoch))
