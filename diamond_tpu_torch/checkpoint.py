"""Weights-only agent snapshots in the JAX package's format (diamond_tpu/checkpoint.py):
one ``.npz`` with a member per leaf, named by the "/"-joined path of the JAX variable
tree (``denoiser/params/unet/d_blocks_0/resblocks_0/conv1/kernel``), so that a snapshot
either package writes loads in the other. The trees come from and go to the port's
modules through the weight bridge (``interop/jax_vars.py``); the int8 ``quant``
collection is never saved (a loaded agent is calibrated again).

The trainer's full state (``checkpoints/state.pt``) is the port's own ``torch.save``.
"""

from __future__ import annotations

import os
import zipfile
from pathlib import Path
from typing import Any, Dict

import numpy as np

SEP = "/"


def flatten_tree(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}{SEP}{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_tree(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten_tree(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split(SEP)
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def save_agent_snapshot(sd: Dict[str, Any], path: Path) -> None:
    """Atomic write (tmp + rename) of a nested tree of arrays as a flat-keyed npz."""
    path = Path(path)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with tmp.open("wb") as f:
        np.savez(f, **flatten_tree(sd))
    os.replace(tmp, path)


def load_agent_snapshot(path: Path) -> Dict[str, Any]:
    path = Path(path)
    if not zipfile.is_zipfile(path):
        raise ValueError(f"{path} is not an npz agent snapshot (the JAX package's older "
                         "pickled snapshots hold jax arrays and load only there)")
    with np.load(path) as z:
        return unflatten_tree({k: z[k] for k in z.files})
