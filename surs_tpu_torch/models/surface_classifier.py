"""Per-point occupancy MLP
(counterpart of ``surs_tpu/models/surface_classifier.py``).

Holds the MLP weights (``conv0`` ... as ``nn.Linear``) and is the plain
reference chain: the original input is re-concatenated before every
layer in ``res_layers``, LeakyReLU(0.01) between layers, sigmoid at the
end. With ``num_views`` V > 1 the rows come as V views of each item:
after layer ``n_layers // 2``'s activation the hidden state is averaged
over the views, and the later residual layers concatenate the view-mean
of the input. Runs in float32. The serving path evaluates the same
weights through kernel K1 (ops/fused_mlp.py) instead.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from .layers import leaky_relu


class SurfaceClassifier(nn.Module):
    def __init__(self, filter_channels: Sequence[int],
                 res_layers: Sequence[int] = (2, 3, 4),
                 no_residual: bool = False, num_views: int = 1):
        super().__init__()
        self.dims = tuple(filter_channels)
        self.num_views = num_views
        self.res_layers = () if no_residual else tuple(res_layers)
        for i in range(len(self.dims) - 1):
            d_in = self.dims[i] + (self.dims[0] if i in self.res_layers
                                   else 0)
            self.add_module(f"conv{i}", nn.Linear(d_in, self.dims[i + 1]))

    def forward(self, feature: torch.Tensor) -> torch.Tensor:
        """feature [B * V, N, C_in] -> occupancy [B, N, C_out] in
        [0, 1]."""
        y = tmpy = feature
        n_layers = len(self.dims) - 1
        for i in range(n_layers):
            inp = torch.cat([y, tmpy], -1) if i in self.res_layers else y
            y = getattr(self, f"conv{i}")(inp)
            if i != n_layers - 1:
                y = leaky_relu(y, 0.01)
            if self.num_views > 1 and i == n_layers // 2:
                V = self.num_views
                y = y.reshape(-1, V, *y.shape[1:]).mean(1)
                tmpy = feature.reshape(-1, V, *feature.shape[1:]).mean(1)
        return torch.sigmoid(y)
