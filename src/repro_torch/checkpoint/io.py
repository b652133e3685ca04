"""The weights and state bridge between the reference and the port.

Counterpart of ``repro/checkpoint/io.py``.  Trees of the port are dicts
keyed by "/"-joined leaf paths, nested one level for optimizer state
(``{"step": ..., "m": {path: tensor}, ...}``), so a leaf's path is the
path the reference writes into its checkpoint manifest.

* ``params_from_numpy`` / ``params_to_numpy`` move a tree between numpy
  arrays and tensors, for parameters and optimizer state alike.
* ``save_checkpoint`` writes a tree in the reference's format: one
  ``.npz`` of arrays ``a0, a1, ...`` and a JSON manifest of
  ``{"step", "leaves": [{"path", "key", "dtype"}]}`` with "/"-joined leaf
  paths; ``restore_checkpoint`` reads such a pair, from either package,
  into the structure of a port tree.
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping

import numpy as np
import torch


def _tensor(arr: np.ndarray, device) -> torch.Tensor:
    """A numpy array as a tensor.  numpy has no bfloat16 of its own: the
    reference's bfloat16 leaves arrive as ``ml_dtypes.bfloat16`` arrays,
    which torch cannot read, so their bits cross as int16."""
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.as_tensor(arr, device=device)


def _array(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host; a bfloat16 tensor's bits as
    numpy's bfloat16, which a library (ml_dtypes, which jax imports) must
    have registered."""
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    try:
        bf16 = np.dtype("bfloat16")
    except TypeError as e:
        raise TypeError("a bfloat16 tensor needs numpy's bfloat16: import "
                        "ml_dtypes (jax imports it) first") from e
    return t.view(torch.int16).numpy().view(bf16)


def params_from_numpy(flat: Mapping[str, Any], device="cuda") -> dict:
    """numpy leaves (nested dicts allowed) -> tensors on ``device``,
    bfloat16 leaves bit for bit."""
    return {k: params_from_numpy(v, device) if isinstance(v, Mapping)
            else _tensor(np.array(v), device) for k, v in flat.items()}


def params_to_numpy(tree: Mapping[str, Any]) -> dict:
    """Tensors (nested dicts allowed) -> numpy arrays on the host,
    bfloat16 leaves bit for bit as numpy's bfloat16 (see ``_array``)."""
    return {k: params_to_numpy(v) if isinstance(v, Mapping) else _array(v)
            for k, v in tree.items()}


# dtypes ``.npz`` stores as they are; others (bfloat16 and friends) are
# stored widened to float32, with the leaf's own dtype in the manifest
_NPZ_DTYPES = tuple(np.dtype(d) for d in (
    np.float32, np.float64, np.int32, np.int64, np.uint32, np.int16, np.uint8,
    np.int8, np.bool_, np.float16, np.uint64, np.uint16))


def _leaf_paths(tree: Mapping[str, Any], prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs of a nested dict, in jax's flatten order (keys
    sorted at every level, which orders "/"-joined paths component by
    component)."""
    out = []
    for k, leaf in tree.items():
        if isinstance(leaf, Mapping):
            out.extend(_leaf_paths(leaf, f"{prefix}{k}/"))
        else:
            out.append((f"{prefix}{k}", leaf))
    return sorted(out, key=lambda pl: pl[0].split("/"))


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf (tensor, array or scalar) as the array to store and the name
    of its own dtype."""
    if isinstance(leaf, torch.Tensor):
        dtype = str(leaf.dtype).removeprefix("torch.")
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.to(torch.float32).numpy(), dtype
        arr = leaf.numpy()
    else:
        arr = np.asarray(leaf)
    dtype = str(arr.dtype)
    if arr.dtype not in _NPZ_DTYPES:
        arr = arr.astype(np.float32)
    return arr, dtype


def save_checkpoint(path: str, tree: Mapping[str, Any], step: int = 0) -> None:
    """Save a tree (params, optimizer state, a cursor; nested dicts of
    tensors, arrays or scalars) to ``path.npz`` + ``path.json``.

    Writes are atomic (a tmp file, then ``os.replace``), the npz before the
    manifest: a crash mid-save leaves the previous pair, or a new npz with
    the old manifest, never a torn npz."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    arrays = {}
    manifest = {"step": int(step), "leaves": []}
    for i, (spath, leaf) in enumerate(_leaf_paths(tree)):
        key = f"a{i}"
        arrays[key], dtype = _to_numpy(leaf)
        manifest["leaves"].append({"path": spath, "key": key, "dtype": dtype})
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path + ".npz")
    tmp = path + ".tmp.json"
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, path + ".json")


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
