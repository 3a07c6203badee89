"""Weight bridge: a Flax ``params`` tree of the JAX package's SuRSNet
(``surs_tpu/models/surs_net.py``), given as nested dicts of numpy
arrays, or its variables ``{"params", "batch_stats"}`` (a batch-norm
model), into the port's ``state_dict``; the same for the legacy PIFu
nets and the color nets (``surs_tpu/models/pifu_legacy.py``: the
backbones, ``MLP``, ``ConvPIFuNet``, ``ResBlkColorNet``, ``RefColorNet``).

The port's submodules carry the Flax module names, so a param path maps
onto a key by joining with dots; only the leaves change:

  * Conv ``kernel`` [kh, kw, in, out] -> ``weight`` [out, in, kh, kw]
  * Dense ``kernel`` [in, out]        -> ``weight`` [out, in] (nn.Linear)
  * Group/BatchNorm ``scale``/``bias`` -> ``weight``/``bias``
  * ``bias``                          -> ``bias``
  * BatchNorm ``mean``/``var`` (``batch_stats``) -> ``running_mean`` /
    ``running_var`` of the same ``bn`` module

Every Flax leaf becomes one key; ``load_flax_params`` loads strictly,
so a leftover leaf or a missing parameter raises.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn


def _convert_leaf(name: str, value: np.ndarray):
    value = np.asarray(value, np.float32)
    if name == "kernel":
        if value.ndim == 4:
            return "weight", value.transpose(3, 2, 0, 1)
        if value.ndim == 2:
            return "weight", value.T
        raise ValueError(f"unexpected kernel rank {value.ndim}")
    if name == "scale":
        return "weight", value
    if name == "bias":
        return "bias", value
    if name in ("mean", "var"):
        return f"running_{name}", value
    raise ValueError(f"unknown Flax leaf {name!r}")


def flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Nested Flax params or batch_stats (numpy leaves) -> flat torch
    state_dict."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for key, child in node.items():
            if isinstance(child, Mapping):
                walk(child, prefix + (key,))
                continue
            leaf, arr = _convert_leaf(key, child)
            out[".".join(prefix + (leaf,))] = torch.from_numpy(
                np.array(arr, order="C"))

    walk(params, ())
    return out


def load_flax_params(module: nn.Module, params: Mapping) -> nn.Module:
    """Load a Flax params tree, or variables ``{"params",
    "batch_stats"}`` (as the JAX ``Reconstructor`` takes them), into
    ``module`` strictly (raises on a leftover leaf or a missing
    parameter or statistic). The values are cast to each parameter's
    dtype and device."""
    trees = ([params["params"], params.get("batch_stats", {})]
             if "params" in params else [params])
    state: Dict[str, torch.Tensor] = {}
    for tree in trees:
        state.update(flax_to_state_dict(tree))
    module.load_state_dict(state, strict=True)
    return module
