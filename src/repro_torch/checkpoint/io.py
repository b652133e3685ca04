"""The weights and state bridge between the reference and the port.

Counterpart of ``repro/checkpoint/io.py``.  Trees of the port are dicts
keyed by "/"-joined leaf paths, nested one level for optimizer state
(``{"step": ..., "m": {path: tensor}, ...}``), so a leaf's path is the
path the reference writes into its checkpoint manifest.

* ``params_from_numpy`` / ``params_to_numpy`` move a tree between numpy
  arrays and tensors, for parameters and optimizer state alike.
* ``restore_checkpoint`` reads the reference's ``.npz`` + JSON manifest
  pair into the structure of a port tree.
"""

from __future__ import annotations

import json
from typing import Any, Mapping

import numpy as np
import torch


def params_from_numpy(flat: Mapping[str, Any], device="cuda") -> dict:
    """numpy leaves (nested dicts allowed) -> tensors on ``device``."""
    return {k: params_from_numpy(v, device) if isinstance(v, Mapping)
            else torch.as_tensor(np.array(v), device=device)
            for k, v in flat.items()}


def params_to_numpy(tree: Mapping[str, Any]) -> dict:
    """Tensors (nested dicts allowed) -> numpy arrays on the host."""
    return {k: params_to_numpy(v) if isinstance(v, Mapping)
            else v.detach().cpu().numpy() for k, v in tree.items()}


def restore_checkpoint(path: str, like: Mapping[str, Any]) -> tuple[dict, int]:
    """Read the reference's ``path.npz`` + ``path.json`` into the structure,
    dtypes and devices of ``like`` (shapes checked).  Returns (tree, step)."""
    with open(path + ".json") as f:
        manifest = json.load(f)
    data = np.load(path + ".npz")
    saved = {l["path"]: data[l["key"]] for l in manifest["leaves"]}

    def fill(tree: Mapping[str, Any], prefix: str) -> dict:
        out = {}
        for k, leaf in tree.items():
            p = f"{prefix}{k}"
            if isinstance(leaf, Mapping):
                out[k] = fill(leaf, p + "/")
                continue
            if p not in saved:
                raise KeyError(f"checkpoint missing leaf {p}")
            arr = saved[p]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch at {p}: "
                                 f"{arr.shape} vs {tuple(leaf.shape)}")
            out[k] = torch.as_tensor(arr, device=leaf.device).to(leaf.dtype)
        return out

    return fill(like, ""), manifest["step"]
