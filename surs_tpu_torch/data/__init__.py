"""Data: the training and eval datasets and the batching loader."""

from .datasets import EvalDataset, TrainDataset
from .loader import DataLoader, collate

__all__ = ["DataLoader", "EvalDataset", "TrainDataset", "collate"]
