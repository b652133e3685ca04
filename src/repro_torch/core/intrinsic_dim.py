"""Intrinsic dimension of the loss Hessian (paper Def. 3.1, Fig. 5), in
PyTorch.

    I = sum_i |lambda_i| / max_i |lambda_i|

Counterpart of ``repro/core/intrinsic_dim.py``: Hessian-vector products
forward-over-reverse (``torch.func.jvp`` of ``torch.func.grad``),
lambda_max by Lanczos with full reorthogonalization, trace(|H|) by
stochastic Lanczos quadrature (SLQ).  The reference keeps the Lanczos
vectors in host numpy; here they are float64 tensors on the matvec's
device, so on the card the reorthogonalization reads HBM, not the host.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from repro_torch import prng

Tree = Mapping[str, torch.Tensor]


def _ravel(params: Tree) -> tuple[torch.Tensor, Callable[[torch.Tensor], dict]]:
    """(flat vector, unravel): the leaves in the dict's order (the port's
    dicts are in jax's flatten order, so this is ``ravel_pytree``'s
    vector), in their common dtype."""
    names = list(params)
    shapes = [params[n].shape for n in names]
    dtypes = [params[n].dtype for n in names]
    sizes = [params[n].numel() for n in names]
    flat = torch.cat([params[n].detach().reshape(-1) for n in names])

    def unravel(v: torch.Tensor) -> dict:
        return {n: part.reshape(s).to(dt) for n, part, s, dt in
                zip(names, torch.split(v, sizes), shapes, dtypes)}

    return flat, unravel


def make_hvp(loss_fn: Callable, params: Tree, batch: Any):
    """Returns (matvec on flat vectors, dim): v -> H v at ``params``,
    forward-over-reverse (the jvp of the gradient along v).

    ``loss_fn`` must not recompute blocks: build it with the model's
    ``remat=False``.  ``torch.func``'s transforms refuse the saved-tensor
    hooks of ``torch.utils.checkpoint``, so the HVP keeps every activation
    where the reference's (``loss_fn`` at its default ``remat=True``)
    recomputes them; the values are the same."""
    flat0, unravel = _ravel(params)
    grad = torch.func.grad(lambda flat: loss_fn(unravel(flat), batch))

    def matvec(v: torch.Tensor) -> torch.Tensor:
        return torch.func.jvp(grad, (flat0,), (v,))[1]

    return matvec, flat0.numel()


def lanczos(matvec: Callable, dim: int, num_iters: int, key: prng.Key,
            v0: Optional[np.ndarray] = None, device="cuda"):
    """Lanczos tridiagonalization with full reorthogonalization, in float64
    on ``device`` (the matvec takes and gives float32).  ``v0`` (default:
    ``prng.normal(key, (dim,))``) is the start vector.

    Returns (ritz_values, ritz_weights) as numpy arrays; the weights are
    the squared first components of the tridiagonal's eigenvectors (for
    SLQ quadrature)."""
    if v0 is None:
        v0 = prng.normal(key, (dim,), device)
    v0 = torch.as_tensor(v0, device=device).to(torch.float64)
    v = v0 / torch.linalg.norm(v0)
    V = [v]
    alphas, betas = [], []
    beta = 0.0
    v_prev = torch.zeros(dim, dtype=torch.float64, device=device)
    for _ in range(num_iters):
        w = matvec(v.to(torch.float32)).to(torch.float64)
        alpha = float(v @ w)
        w = w - alpha * v - beta * v_prev
        # full reorthogonalization (twice for stability)
        for _ in range(2):
            for u in V:
                w = w - (u @ w) * u
        beta = float(torch.linalg.norm(w))
        alphas.append(alpha)
        if beta < 1e-10 or len(alphas) == num_iters:
            break
        v_prev, v = v, w / beta
        V.append(v)
        betas.append(beta)
    T = np.diag(alphas) + np.diag(betas, 1) + np.diag(betas, -1)
    evals, evecs = np.linalg.eigh(T)
    return evals, evecs[0, :] ** 2


def hessian_spectrum_slq(loss_fn: Callable, params: Tree, batch: Any,
                         num_iters: int = 30, num_probes: int = 4,
                         key: Optional[prng.Key] = None):
    """Approximate (eigenvalue nodes, density weights, dim) of the Hessian
    spectrum via SLQ -- the quantity plotted in paper Fig. 5.  Probe p
    starts from ``prng.normal(fold_in(key, p))`` on the parameters'
    device."""
    key = prng.key(0) if key is None else key
    matvec, d = make_hvp(loss_fn, params, batch)
    device = next(iter(params.values())).device
    nodes, weights = [], []
    for p in range(num_probes):
        ev, w = lanczos(matvec, d, num_iters, prng.fold_in(key, p),
                        device=device)
        nodes.append(ev)
        weights.append(w / num_probes)
    return np.concatenate(nodes), np.concatenate(weights), d


def intrinsic_dimension(loss_fn: Callable, params: Tree, batch: Any,
                        num_iters: int = 30, num_probes: int = 4,
                        key: Optional[prng.Key] = None) -> dict:
    """Estimate I = trace(|H|) / lambda_max and related diagnostics."""
    nodes, weights, d = hessian_spectrum_slq(
        loss_fn, params, batch, num_iters, num_probes, key)
    trace_abs = float(d * np.sum(weights * np.abs(nodes)))
    lam_max = float(np.max(np.abs(nodes)))
    return {
        "intrinsic_dim": trace_abs / max(lam_max, 1e-12),
        "lambda_max": lam_max,
        "trace_abs": trace_abs,
        "ambient_dim": d,
        "nodes": nodes,
        "weights": weights,
    }
