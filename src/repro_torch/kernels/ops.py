"""Dispatch between the Hopper kernels and their plain versions.

Counterpart of ``repro/kernels/ops.py``.  The route follows the device of
the tensor given: a CUDA tensor goes to the kernel, which launches or
raises (there is no fallback when a build or a launch fails); a CPU tensor
goes to the plain PyTorch version, the role ``interpret=True`` plays in the
reference.  ``repro_torch.core`` calls these when
``SketchConfig.use_kernels`` is set; nothing there calls the Gaussian
pair, as in the reference.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import countsketch as _cs
from repro_torch.kernels import fwht as _fw
from repro_torch.kernels import gaussian_sketch as _gs

MAX_N = _fw.MAX_N


def _on_cuda(x: torch.Tensor) -> bool:
    if x.is_cuda:
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel route for device {x.device}")


def countsketch_clients(x: torch.Tensor, h: torch.Tensor, b: int) -> torch.Tensor:
    """Batched count-sketch over the client axis: x (G, n) -> (G, b)."""
    if _on_cuda(x):
        return _cs.countsketch_clients_cuda(x, h, b)
    return _cs.countsketch_clients_plain(x, h, b)


def countsketch(x: torch.Tensor, h: torch.Tensor, b: int) -> torch.Tensor:
    """Count-sketch aggregation of one vector: out[j] = sum_{h[i]==j} x[i]."""
    return countsketch_clients(x.reshape(1, -1), h, b).reshape(b)


def fwht_rows(x: torch.Tensor) -> torch.Tensor:
    """Unnormalized FWHT along the last axis of (R, C), C a power of 2 up to
    ``MAX_N`` (the reference's two-level Kronecker limit)."""
    c = x.shape[-1]
    if c > MAX_N:
        raise ValueError(f"fwht supports lengths <= {MAX_N}, got {c}")
    if _on_cuda(x):
        return _fw.fwht_rows_cuda(x)
    return _fw.fwht_plain(x)


def fwht(v: torch.Tensor) -> torch.Tensor:
    """Unnormalized FWHT of a power-of-2-length vector."""
    return fwht_rows(v.reshape(1, -1)).reshape(-1)


def gaussian_sk(seed: int, x: torch.Tensor, b: int) -> torch.Tensor:
    """sk(x) = R x / sqrt(b), R (b, n) regenerated from ``seed`` (uint32)."""
    if _on_cuda(x):
        return _gs.gaussian_sk_cuda(seed, x, b)
    return _gs.gaussian_sk_plain(seed, x, b)


def gaussian_desk(seed: int, s: torch.Tensor, n: int) -> torch.Tensor:
    """desk(s) = R^T s / sqrt(b), from the same R as ``gaussian_sk``."""
    if _on_cuda(s):
        return _gs.gaussian_desk_cuda(seed, s, n)
    return _gs.gaussian_desk_plain(seed, s, n)
