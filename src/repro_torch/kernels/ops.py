"""Dispatch between the Hopper kernels and their plain versions.

Counterpart of ``repro/kernels/ops.py``.  The route follows the device of
the tensor given: a CUDA tensor goes to the kernel, which launches or
raises (there is no fallback when a build or a launch fails); a CPU tensor
goes to the plain PyTorch version, the role ``interpret=True`` plays in the
reference; a ``meta`` tensor (the dry run, ``launch/dryrun.py``) gets an
empty ``meta`` output of the kernel's shape, and the launch and the bytes
its bound counts (each input read once, the output written once) go to
the active ``launch.op_costs.OpCosts``, and B1's and B2's workspace is
held on ``meta`` while the launch runs, as their CUDA routes hold it (B3's
per-split partial sums, a few (splits, b) floats, are not); the plain
version's operations
are not what the card runs, so they are not traced.  Any other device
raises.  ``repro_torch.core`` calls these when
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


def _is_meta(x: torch.Tensor) -> bool:
    return x.device.type == "meta"


def _meta_launch(name: str, shape, nbytes: float, scratch: int = 0) -> torch.Tensor:
    """The meta route: one launch of ``name`` moving ``nbytes``, recorded in
    the active ``OpCosts``, and its float32 output's shape; ``scratch``
    int32s of workspace are held while it runs, as the CUDA route holds
    them."""
    from repro_torch.launch.op_costs import record_kernel
    out = torch.empty(shape, dtype=torch.float32, device="meta")
    work = torch.empty(scratch, dtype=torch.int32, device="meta")
    record_kernel(name, nbytes)
    del work
    return out


def countsketch_clients(x: torch.Tensor, h: torch.Tensor, b: int) -> torch.Tensor:
    """Batched count-sketch over the client axis: x (G, n) -> (G, b)."""
    if _is_meta(x):
        g, n = x.shape
        width, large = _cs.route(n, b)
        return _meta_launch("countsketch_clients", (g, b), x.numel() * 4
                            + h.numel() * h.element_size() + g * b * 4,
                            _cs.work_ints(n, -(-b // width), large) if g else 0)
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
    if _is_meta(x):
        return _meta_launch("fwht_rows", tuple(x.shape), 2 * x.numel() * 4,
                            x.shape[0] + 1 if _fw.split(c)[0] > 1 else 0)
    if _on_cuda(x):
        return _fw.fwht_rows_cuda(x)
    return _fw.fwht_plain(x)


def fwht(v: torch.Tensor) -> torch.Tensor:
    """Unnormalized FWHT of a power-of-2-length vector."""
    return fwht_rows(v.reshape(1, -1)).reshape(-1)


def gaussian_sk(seed: int, x: torch.Tensor, b: int) -> torch.Tensor:
    """sk(x) = R x / sqrt(b), R (b, n) regenerated from ``seed`` (uint32)."""
    if _is_meta(x):
        return _meta_launch("gaussian_sk", (b,), (x.numel() + b) * 4)
    if _on_cuda(x):
        return _gs.gaussian_sk_cuda(seed, x, b)
    return _gs.gaussian_sk_plain(seed, x, b)


def gaussian_desk(seed: int, s: torch.Tensor, n: int) -> torch.Tensor:
    """desk(s) = R^T s / sqrt(b), from the same R as ``gaussian_sk``."""
    if _is_meta(s):
        return _meta_launch("gaussian_desk", (n,), (n + s.numel()) * 4)
    if _on_cuda(s):
        return _gs.gaussian_desk_cuda(seed, s, n)
    return _gs.gaussian_desk_plain(seed, s, n)
