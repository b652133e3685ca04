"""SAFL: Sketched Adaptive Federated Learning (paper Algorithm 1), in PyTorch.

Counterpart of ``repro/core/safl.py``, materialized path without hooks.
One round:

  1. every client starts from the global iterate and runs K local SGD
     steps with client lr eta;
  2. its delta x_0 - x_K is sketched with the round's shared operator
     into one ``(G, b_total)`` payload (``core.packed``);
  3. the server averages the G sketches (by linearity, the sketch of the
     mean delta), desketches the mean and takes one ADA_OPT step.

The reference vmaps the clients; the port loops over them and stacks the
deltas into the same ``(G, ...)`` leaves.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional

import torch

from repro_torch import prng
from repro_torch.core.adaptive import AdaConfig, apply_update, init_opt_state
from repro_torch.core.packed import (PackingPlan, derive_round_params,
                                     desk_packed, make_packing_plan,
                                     sk_packed_clients)
from repro_torch.core.sketch import SketchConfig, total_sketch_bits

Tree = Mapping[str, torch.Tensor]
LossFn = Callable[[Tree, Any], torch.Tensor]  # (params, batch) -> scalar loss


@dataclasses.dataclass(frozen=True)
class SAFLConfig:
    sketch: SketchConfig = SketchConfig()
    server: AdaConfig = AdaConfig()
    client_lr: float = 0.1          # eta
    local_steps: int = 1            # K
    remat_local: bool = True        # no effect here: recomputation changes no value


def tree_sub(a: Tree, b: Tree) -> dict[str, torch.Tensor]:
    return {k: a[k].to(torch.float32) - b[k].to(torch.float32) for k in a}


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean over the leading (client) axis, restricted to a (G,) 0/1 mask."""
    if mask is None:
        return torch.mean(x, dim=0)
    m = mask.reshape(mask.shape + (1,) * (x.dim() - 1)).to(x.dtype)
    den = torch.clamp(torch.sum(mask), min=1.0).to(x.dtype)
    return torch.sum(x * m, dim=0) / den


def client_delta(cfg: SAFLConfig, loss_fn: LossFn, params: Tree,
                 microbatches: Mapping[str, torch.Tensor],
                 eta: float) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """K local SGD steps for ONE client; returns (x_0 - x_K, mean loss).
    ``microbatches`` leaves have leading axis K."""
    names = list(params)
    p = dict(params)
    losses = []
    for k in range(next(iter(microbatches.values())).shape[0]):
        leaves = [p[n].detach().requires_grad_(True) for n in names]
        mb = {key: v[k] for key, v in microbatches.items()}
        loss = loss_fn(dict(zip(names, leaves)), mb)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        with torch.no_grad():
            p = {n: x if g is None else
                 (x.to(torch.float32) - eta * g.to(torch.float32)).to(x.dtype)
                 for n, x, g in zip(names, leaves, grads)}
        losses.append(loss.detach())
    with torch.no_grad():
        return tree_sub(params, p), torch.mean(torch.stack(losses))


def safl_round(cfg: SAFLConfig, loss_fn: LossFn, params: Tree,
               opt_state: dict, batch: Mapping[str, torch.Tensor],
               round_key: prng.Key, eta_scale: float = 1.0,
               lr_scale: float = 1.0, *,
               plan: Optional[PackingPlan] = None) -> tuple[dict, dict, dict]:
    """One full SAFL round over all clients.  ``batch`` leaves are shaped
    (G, K, mb, ...).  ``plan`` is the static packing layout (built once by
    multi-round callers).  Returns (params, opt_state, metrics)."""
    eta = float(torch.tensor(cfg.client_lr * eta_scale, dtype=torch.float32))
    g = next(iter(batch.values())).shape[0]
    per_client = [client_delta(cfg, loss_fn, params,
                               {k: v[c] for k, v in batch.items()}, eta)
                  for c in range(g)]
    deltas = {k: torch.stack([d[k] for d, _ in per_client]) for k in params}
    losses = torch.stack([l for _, l in per_client])
    del per_client

    device = next(iter(params.values())).device
    if plan is None:
        plan = make_packing_plan(cfg.sketch, params)
    rp = derive_round_params(plan, round_key, device)
    sketches = sk_packed_clients(plan, rp, deltas)
    del deltas

    mbar = masked_mean(sketches)
    update = desk_packed(plan, rp, mbar)
    new_params, new_opt = apply_update(cfg.server, opt_state, params, update,
                                       lr_scale=lr_scale)
    return new_params, new_opt, {"loss": masked_mean(losses)}


def init_safl(cfg: SAFLConfig, params: Tree) -> dict:
    """Server moment state (m_0 = v_0 = v̂_0 = 0)."""
    return init_opt_state(cfg.server, params)


def split_client_batches(batch: Mapping[str, torch.Tensor], num_clients: int,
                         local_steps: int) -> dict[str, torch.Tensor]:
    """Reshape a global batch (B, ...) -> (G, K, B/(G*K), ...)."""
    def reshape(x):
        b = x.shape[0]
        assert b % (num_clients * local_steps) == 0, (
            f"batch {b} not divisible by G*K={num_clients * local_steps}")
        return x.reshape(num_clients, local_steps,
                         b // (num_clients * local_steps), *x.shape[1:])
    return {k: reshape(v) for k, v in batch.items()}


def uplink_bits_per_round(cfg: SAFLConfig, params: Tree,
                          cohort_size: int = 1) -> int:
    """Uplink payload in bits per round, for ``cohort_size`` transmitting
    clients (default: the per-client payload)."""
    assert cohort_size >= 1, "a round must have at least one uplinking client"
    return total_sketch_bits(cfg.sketch, params) * int(cohort_size)
