"""Weight bridge between the JAX package's variables and the port's state dicts.

The port keeps the JAX package's parameter names, shapes and layouts, so a model's state
dict is its flax variable tree flattened, paths joined with ".": the ``params``
collection becomes the parameters and ``constants`` (FourierFeatures' frequencies) the
buffers. The int8 ``quant`` collection (calibrated ``act_scale`` with ``w_q``/``w_scale``,
keyed by the same paths, the LSTM's at ``lstm.cell``) goes into the sites' collection
buffers (ops/quant.py ``install``) and comes back out of them, ``w_q`` as int8 and the
scales as f32. Trees here are nested dicts of numpy arrays (``jax.tree_util.tree_map(
np.asarray, variables)`` on the JAX side); this module imports no jax.

Published DIAMOND checkpoints reach the port through its own numpy-only converter:
``interop/reference_ckpt.py`` ``convert_reference_state_dict`` gives these trees, and
``variables_to_state_dict`` (or ``Agent.load_state_dict``) finishes the trip.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from ..ops import quant

COLLECTIONS = ("params", "constants")
QUANT = "quant"


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
    return out


def _unflatten(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def variables_to_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """{"params": tree, "constants": tree} -> flat state dict of float32 CPU tensors
    (a "quant" collection is not state; ``load_variables`` installs it)."""
    extra = set(variables) - set(COLLECTIONS) - {QUANT}
    if extra:
        raise ValueError(f"collections {sorted(extra)} have no counterpart in the port")
    sd: Dict[str, torch.Tensor] = {}
    for coll in COLLECTIONS:
        for k, v in _flatten(variables.get(coll, {})).items():
            if k in sd:
                raise ValueError(f"{k} is in more than one collection")
            sd[k] = torch.from_numpy(np.array(v, dtype=np.float32))
    return sd


def module_to_variables(module: nn.Module) -> Dict[str, Any]:
    """The inverse: a port module's weights as {"params": tree[, "constants": tree]
    [, "quant": tree]} of numpy arrays."""
    buffers = {k for k, _ in module.named_buffers()}
    colls: Dict[str, Dict[str, np.ndarray]] = {"params": {}, "constants": {}}
    for k, v in module.state_dict().items():
        colls["constants" if k in buffers else "params"][k] = v.detach().cpu().numpy()
    out = {c: _unflatten(flat) for c, flat in colls.items() if flat}
    q = quant.collection(module)
    if q:
        out[QUANT] = _unflatten({k: v.detach().cpu().numpy() for k, v in _flatten(q).items()})
    return out


def load_variables(module: nn.Module, variables: Mapping[str, Any]) -> nn.Module:
    """Load JAX variables into ``module`` (strict: every key must match both ways), and
    its "quant" collection, if it has one, into the sites (any previous one dropped)."""
    sd = variables_to_state_dict(variables)
    module.load_state_dict(sd, strict=True)
    quant.install(module, variables.get(QUANT, {}))
    return module
