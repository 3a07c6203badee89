"""Reference checkpoints into the port (counterpart of
``surs_tpu/compat/torch_import.py``, its netG part).

The reference saves ``torch.save(netG.state_dict())`` files. Its keys
map onto the JAX package's Flax param paths, with the leaves in Flax's
layout:

  * Conv2d [out, in, kh, kw] -> kernel [kh, kw, in, out]
  * Conv1d [out, in, 1]      -> Dense kernel [in, out]
  * GroupNorm weight / bias  -> scale / bias of the ``gn`` (group) or
    ``bn`` (batch) norm submodule, whichever the target model has
  * BatchNorm running_mean / running_var -> the ``bn`` submodule's
    ``mean`` / ``var`` (Flax's ``batch_stats``); num_batches_tracked has
    no counterpart and is skipped

and the port's submodules carry the Flax names, so the Flax tree goes
through the weight bridge (``flax_import.flax_to_state_dict``) to the
port's state_dict keys. Parameters the reference constructs but never
uses are dropped: HGFilter's conv1 / bn1 / conv3 / conv4 stems and down
convs, conv5 of the lr filter, the hr filter's hourglass stacks,
SuRSSR's MeanShift buffers, the ``downsample.0`` aliases of ConvBlock's
bn4, and a bn4 without its downsample conv.

``load_netG`` loads ``cfg.load_netG_checkpoint_path`` into a model: a
port ``netG_*`` file strictly, a reference state dict as the JAX
package does (non-strict, a count printed), the running statistics of
a batch-norm model with it. The JAX package's orbax directories
(ROADMAP.md A17) and netC, the color net (A11), are not read.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch.nn as nn

from ..train.checkpoint import load_model_state
from .flax_import import flax_to_state_dict

# state-dict keys that exist in reference checkpoints but have no live
# consumer in the forward pass
_DROP_PATTERNS = [
    r"^image_filter_hr\.(conv1|bn1|conv2|conv3|conv4|down_conv2)\.",
    # conv5 is constructed unconditionally but only consumed in
    # 'high_res' mode: dead in the lr filter
    r"^image_filter_lr\.(conv1|bn1|conv3|conv4|conv5|down_conv2)\.",
    r"^super_resolution\.(sub_mean|add_mean)\.",
    r"\.downsample\.0\.",   # alias of bn4 (the same tensor)
    r"^image_filter_hr\.(m\d+|top_m_\d+|conv_last\d+|bn_end\d+|l\d+|bl\d+"
    r"|al\d+)\.",           # hr hourglass stacks are dead in 'high_res' mode
]

# the norm submodule of a path: 'gn' or 'bn', resolved against the target
_NORM_DIR = "<norm>"


def _is_dead_bn4(torch_key: str, state_dict) -> bool:
    """A ConvBlock's bn4 with no sibling downsample conv is constructed
    but never consumed."""
    m = re.match(r"^(.*)\.bn4\.", torch_key)
    return bool(m) and f"{m.group(1)}.downsample.2.weight" not in state_dict


def _convblock_path(parts) -> Tuple[str, ...]:
    """Path inside a ConvBlock: conv1..3, bn1..4, downsample.2."""
    head = parts[0]
    if head == "downsample":
        return ("downsample_conv",)
    if head.startswith("bn"):
        return (head, _NORM_DIR)
    return (head,)


def _flax_path(torch_key: str) -> Optional[Tuple[str, ...]]:
    """A reference key -> its Flax param path without the leaf name, or
    None to drop it."""
    for pat in _DROP_PATTERNS:
        if re.search(pat, torch_key):
            return None
    parts = torch_key.split(".")
    mod = parts[0]

    if mod in ("mlp_lr", "mlp_hr"):
        return (mod, parts[1])                   # mlp_lr.conv0.weight

    if mod == "super_resolution":
        sub = parts[1]
        seq_idx = parts[2] if len(parts) > 3 else None
        if sub in ("head", "down1", "down2", "down3", "bottleneck",
                   "bott2", "ups2", "ups3", "ups4"):
            return ("super_resolution", sub, "conv")
        if sub.startswith("body"):
            # body1.0.body.0.weight -> body1_0/conv0
            conv_idx = {"0": "conv0", "2": "conv1"}[parts[4]]
            return ("super_resolution", f"{sub}_{parts[2]}", conv_idx)
        if sub.startswith("tail"):
            # tail1.0 / tail1.2 -> tail1_0/conv, tail1_1/conv
            name = {"0": f"{sub}_0", "2": f"{sub}_1"}[seq_idx]
            return ("super_resolution", name, "conv")
        if sub == "last":
            if seq_idx == "0":
                return ("super_resolution", "last_0", "conv")
            return ("super_resolution", "last_1")
        return None  # pixel shuffle and upsampling have no parameters

    if mod in ("image_filter_lr", "image_filter_hr"):
        sub = parts[1]
        if sub == "conv5":
            return (mod, "conv5")
        if sub == "conv2":  # ConvBlock stem
            return (mod, "conv2") + _convblock_path(parts[2:])
        if re.match(r"m(\d+)$", sub):
            # hourglass: image_filter_lr.m0.b1_2.conv1.weight
            return (mod, sub, parts[2]) + _convblock_path(parts[3:])
        if re.match(r"top_m_(\d+)$", sub):
            return (mod, sub) + _convblock_path(parts[2:])
        if re.match(r"(conv_last|l|bl|al)\d+$", sub):
            return (mod, sub)
        if re.match(r"bn_end(\d+)$", sub):
            return (mod, sub, _NORM_DIR)
        return None

    return None


def _convert_leaf(torch_key: str, arr: np.ndarray):
    """(Flax leaf name, value in Flax's layout) of a state-dict entry;
    (None, None) for entries without a counterpart
    (num_batches_tracked)."""
    leaf = torch_key.split(".")[-1]
    if leaf == "weight":
        if arr.ndim == 4:       # Conv2d
            return "kernel", arr.transpose(2, 3, 1, 0)
        if arr.ndim == 3:       # Conv1d (1x1) -> Dense
            return "kernel", arr[:, :, 0].T
        return "scale", arr     # norm weight
    if leaf == "bias":
        return "bias", arr
    if leaf == "running_mean":
        return "mean", arr
    if leaf == "running_var":
        return "var", arr
    return None, None


def _norm_dir(keys, path: Tuple[str, ...]) -> Optional[str]:
    """'gn' or 'bn', whichever norm submodule the target has at
    ``path`` (a prefix of its state_dict keys), or None."""
    prefix = ".".join(path)
    for name in ("gn", "bn"):
        if any(k.startswith(f"{prefix}.{name}.") for k in keys):
            return name
    return None


def reference_to_flax(state_dict: Mapping, model: nn.Module
                      ) -> Tuple[Dict, int]:
    """A reference state dict -> (the nested Flax tree, numpy leaves in
    Flax's layout, of the entries that land in ``model``'s parameters
    and batch-norm statistics; their count). The statistics sit beside
    the parameters, as ``mean`` / ``var`` leaves of each ``bn`` module
    (Flax keeps them in a ``batch_stats`` tree of the same paths).
    Entries without a place in ``model`` are skipped, as the JAX
    package's non-strict import skips them; a shape that disagrees
    raises."""
    target = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    tree: Dict = {}
    n = 0
    for key, val in state_dict.items():
        if _is_dead_bn4(key, state_dict):
            continue
        path = _flax_path(key)
        if path is None:
            continue
        arr = val.detach().cpu().numpy() if hasattr(val, "detach") \
            else np.asarray(val)
        leaf, arr = _convert_leaf(key, arr)
        if leaf is None:
            continue
        if _NORM_DIR in path:
            i = path.index(_NORM_DIR)
            norm = _norm_dir(target, path[:i])
            if norm is None:
                continue
            path = path[:i] + (norm,) + path[i + 1:]
        port_key, value = next(iter(flax_to_state_dict(
            {leaf: arr}).items()))
        port_key = ".".join(path + (port_key,))
        if port_key not in target:
            continue
        if target[port_key] != tuple(value.shape):
            raise ValueError(f"shape mismatch at {key} -> {port_key}: "
                             f"{target[port_key]} vs {tuple(value.shape)}")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr
        n += 1
    return tree, n


def import_torch_state_dict(state_dict: Mapping, model: nn.Module) -> int:
    """Load a reference state dict into ``model`` (non-strict, as the
    JAX package's ``load_params``); returns the count of tensors
    imported. A batch-norm model's running statistics are all required:
    one missing from the file raises rather than leave the model
    normalising with untrained statistics."""
    tree, n = reference_to_flax(state_dict, model)
    state = flax_to_state_dict(tree)
    missing = [k for k in model.state_dict()
               if k.endswith((".running_mean", ".running_var"))
               and k not in state]
    if missing:
        raise ValueError(
            f"{len(missing)} batch-norm running statistics of the model "
            f"are not in the state dict (first: {missing[0]}); the model "
            "would normalise with untrained statistics")
    model.load_state_dict(state, strict=False)
    return n


def load_netG(cfg, model: nn.Module) -> int:
    """Load ``cfg.load_netG_checkpoint_path`` into ``model``
    (``surs_tpu/compat/torch_import.py:load_params``); returns the count
    of tensors loaded. A port ``netG_*`` file loads strictly, the model
    alone; a reference state dict non-strictly, with the count printed;
    without a path the model keeps its random weights from ``cfg.seed``.
    An orbax train-state directory raises."""
    path = cfg.load_netG_checkpoint_path
    if not path:
        print("WARNING: no checkpoint given — using random init")
        return 0
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path}: the JAX package's orbax train-state directories are "
            "not read yet (ROADMAP.md A17); load a port netG_* file or a "
            "reference state dict")
    state, blob = load_model_state(path)
    if blob is not None:
        model.load_state_dict(state, strict=True)
        return len(state)
    n = import_torch_state_dict(state, model)
    print(f"imported {n} tensors from torch checkpoint {path}")
    return n
