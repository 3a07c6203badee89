"""The JAX package's orbax train states into the port.

``surs_tpu/train/checkpoint.py`` saves its ``TrainState`` (``step``,
``params``, ``opt_state``, ``batch_stats``) with orbax's
``StandardCheckpointer`` as a directory ``netG_latest`` /
``netG_epoch_N``: a ``_METADATA`` file naming every leaf by its tree
path, and the arrays in a zarr store (an ``ocdbt`` key-value store in
recent orbax versions). This module reads such a directory with
``tensorstore`` alone: no JAX, no orbax. ``tensorstore`` is imported
when a directory is read; without it the reader raises an error that
names it.

The leaves come from the directory's own metadata, not from a layout
written down here: each array leaf's key is its path joined by dots, and
the zarr format (``zarr`` or ``zarr3``) is the one whose metadata file
the store holds for that key. Leaves that orbax marks as skipped
(``None`` as ``batch_stats`` of a group-norm model, optax's empty
states) are left out.

What lands where:

  * ``params`` and ``batch_stats``: through the weight bridge
    (``flax_import.flax_to_state_dict``) into the model, strictly;
  * ``opt_state``: optax's ``inject_hyperparams`` state, its learning
    rate into every parameter group, and the moments of the inner chain
    (``mu`` / ``nu`` / ``nu_max`` / ``trace`` and Adam's ``count``,
    whatever chain position they sit at, so with or without
    ``add_decayed_weights``) into the state of the port's
    ``train/optim.OptaxOptimizer``, each moment in its parameter's
    layout;
  * ``step`` into the train state.
"""

from __future__ import annotations

import json
import os
from collections.abc import Mapping
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from .flax_import import flax_to_state_dict

METADATA = "_METADATA"
# the optax moment fields the port's optimizer keeps, by kind
_MOMENTS = ("mu", "nu", "nu_max", "trace")
_NEEDS = {"SGD": ("trace",), "ADAM": ("mu", "nu"),
          "AMSgrad": ("mu", "nu", "nu_max"), "RMSprop": ("nu",)}


def _tensorstore():
    try:
        import tensorstore
    except ImportError as e:
        raise RuntimeError(
            "reading the JAX package's orbax checkpoint directories needs "
            "the tensorstore package, which is not installed") from e
    return tensorstore


def _leaf_names(path: str) -> Dict[Tuple[str, ...], str]:
    """{tree path: store key} of every array leaf in the directory's
    ``_METADATA``."""
    meta_path = os.path.join(path, METADATA)
    if not os.path.isfile(meta_path):
        raise FileNotFoundError(
            f"{path}: not an orbax checkpoint directory: its {METADATA} "
            "file (the tree of leaves orbax's StandardCheckpointer writes "
            "beside the array store) is missing")
    with open(meta_path) as f:
        meta = json.load(f)
    tree = meta.get("tree_metadata")
    if not isinstance(tree, Mapping):
        raise ValueError(f"{meta_path}: no tree_metadata; not a "
                         "StandardCheckpointer directory")
    leaves = {}
    for entry in tree.values():
        value = entry.get("value_metadata", {})
        if value.get("skip_deserialize"):
            continue
        keys = tuple(str(k["key"]) for k in entry["key_metadata"])
        leaves[keys] = ".".join(keys)
    return leaves


def read_tree(path: str) -> Dict:
    """An orbax StandardCheckpointer directory -> the nested dict of its
    array leaves (numpy), keyed by the tree path's keys (named-tuple
    fields by name, sequence positions as "0", "1", ...)."""
    leaves = _leaf_names(path)
    ts = _tensorstore()
    if os.path.isfile(os.path.join(path, "manifest.ocdbt")):
        kv_spec = {"driver": "ocdbt", "base": "file://" + os.path.abspath(
            path) + "/"}
    else:
        kv_spec = {"driver": "file", "path": os.path.abspath(path) + "/"}
    kv = ts.KvStore.open(kv_spec).result()
    stored = {k.decode() for k in kv.list().result()}
    out: Dict = {}
    for keys, name in sorted(leaves.items()):
        if f"{name}/.zarray" in stored:
            fmt = "zarr"
        elif f"{name}/zarr.json" in stored:
            fmt = "zarr3"
        else:
            raise ValueError(f"{path}: leaf {name} is in {METADATA} but "
                             "not in the array store")
        arr = ts.open({"driver": fmt,
                       "kvstore": {**kv_spec, "path": name + "/"}},
                      open=True).result().read().result()
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = np.asarray(arr)
    return out


def resolve_tag(path: str) -> str:
    """The directory that the JAX package's ``load_params`` reads for
    ``path`` (``surs_tpu/compat/torch_import.py:293-305``): a
    ``netG_epoch_N`` directory itself, anything else ``netG_latest``
    beside it."""
    path = os.path.abspath(os.path.normpath(path))
    tag = os.path.basename(path)
    if tag.startswith("netG_epoch_"):
        return path
    return os.path.join(os.path.dirname(path), "netG_latest")


def _variables(tree: Mapping, path: str) -> Dict:
    if "params" not in tree:
        raise ValueError(f"{path}: the checkpoint holds no params "
                         f"(top-level leaves: {sorted(tree)})")
    variables = {"params": tree["params"]}
    if tree.get("batch_stats"):
        variables["batch_stats"] = tree["batch_stats"]
    return variables


def load_model(path: str, model: nn.Module, tree: Optional[Dict] = None
               ) -> int:
    """Load the ``params`` (and a batch-norm model's ``batch_stats``) of
    the orbax directory ``path`` into ``model`` strictly; returns the
    count of tensors loaded."""
    tree = read_tree(path) if tree is None else tree
    state: Dict[str, torch.Tensor] = {}
    for sub in _variables(tree, path).values():
        state.update(flax_to_state_dict(sub))
    model.load_state_dict(state, strict=True)
    return len(state)


def _find_moments(opt_state: Mapping, path: str
                  ) -> Tuple[Dict[str, Mapping], Optional[np.ndarray]]:
    """The moment trees of optax's inner chain ({field: params-shaped
    tree}) and its step count (Adam's / AMSgrad's ``count``), wherever
    in the chain they sit."""
    moments: Dict[str, Mapping] = {}
    counts = []

    def walk(node):
        for key, child in node.items():
            if key in _MOMENTS and isinstance(child, Mapping):
                if key in moments:
                    raise ValueError(f"{path}: two optimizer states hold "
                                     f"a {key!r} tree")
                moments[key] = child
            elif key == "count" and not isinstance(child, Mapping):
                counts.append(child)
            elif isinstance(child, Mapping):
                walk(child)

    inner = opt_state.get("inner_state")
    if not isinstance(inner, Mapping):
        raise ValueError(f"{path}: opt_state has no inner_state (optax's "
                         "inject_hyperparams state)")
    walk(inner)
    if len(counts) > 1:
        raise ValueError(f"{path}: {len(counts)} step counts in the "
                         "optimizer's inner state")
    return moments, (counts[0] if counts else None)


def load_optimizer(path: str, model: nn.Module, optimizer, tree: Dict
                   ) -> None:
    """The optax state of ``tree["opt_state"]`` into the port's
    ``OptaxOptimizer`` over ``model``'s parameters: the learning rate
    into every group, the moments of ``optimizer.kind`` into each
    parameter's state (on its device), Adam's count beside them."""
    from ..train.optim import set_learning_rate

    opt_state = tree.get("opt_state")
    if not isinstance(opt_state, Mapping):
        raise ValueError(f"{path}: the checkpoint holds no opt_state; a "
                         "trainer resumes from a whole train state")
    lr = opt_state.get("hyperparams", {}).get("learning_rate")
    if lr is None:
        raise ValueError(f"{path}: opt_state has no injected "
                         "learning_rate (optax inject_hyperparams)")
    moments, count = _find_moments(opt_state, path)
    kind = optimizer.kind
    needs = _NEEDS[kind]
    if kind == "SGD" and not optimizer.param_groups[0]["momentum"]:
        needs = ()
    needs_count = kind in ("ADAM", "AMSgrad")
    if any(m not in moments for m in needs) or (needs_count
                                                and count is None):
        raise ValueError(
            f"{path}: the optimizer state holds {sorted(moments)}"
            f"{' and a count' if count is not None else ''}; {kind} "
            f"needs {list(needs)}{' and a count' if needs_count else ''}")
    params = dict(model.named_parameters())
    per_param: Dict[str, Dict[str, torch.Tensor]] = {}
    for name in needs:
        for key, value in flax_to_state_dict(moments[name]).items():
            if key not in params:
                raise ValueError(f"{path}: optimizer moment {name} of "
                                 f"{key}, which the model does not have")
            per_param.setdefault(key, {})[name] = value
    if needs and set(per_param) != set(params):
        absent = sorted(set(params) - set(per_param))
        raise ValueError(f"{path}: no optimizer moments for {len(absent)} "
                         f"parameters (first: {absent[0]})")
    optimizer.state.clear()
    for key, st in per_param.items():
        p = params[key]
        state = {n: v.to(device=p.device, dtype=p.dtype)
                 for n, v in st.items()}
        if count is not None:
            state["count"] = torch.tensor(int(count), dtype=torch.int32,
                                          device=p.device)
        optimizer.state[p] = state
    set_learning_rate(optimizer, float(lr))


def restore_train_state(path: str, state) -> None:
    """A JAX train-state directory into the port's ``TrainState`` in
    place: the model's parameters (and batch statistics), the optimizer's
    moments and learning rate, and the step."""
    tree = read_tree(path)
    load_model(path, state.model, tree)
    load_optimizer(path, state.model, state.optimizer, tree)
    if "step" not in tree:
        raise ValueError(f"{path}: the checkpoint holds no step")
    state.step = int(tree["step"])
