"""SAFL: Sketched Adaptive Federated Learning (paper Algorithm 1), in PyTorch.

Counterpart of ``repro/core/safl.py``: the materialized round, with the
participation mask (``part_mask``) as its one hook, and the uncompressed
FedOPT round.  One round:

  1. every client starts from the global iterate and runs K local SGD
     steps with client lr eta;
  2. its delta x_0 - x_K is sketched with the round's shared operator
     into one ``(G, b_total)`` payload (``core.packed``);
  3. the server averages the G sketches (by linearity, the sketch of the
     mean delta), desketches the mean and takes one ADA_OPT step.

The reference vmaps the clients; the port loops over them and stacks the
deltas into the same ``(G, ...)`` leaves.  Under partial participation
every client still computes (static shapes, as in the reference's
simulation); the mask decides what the server averages.
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


def mask_weights(mask) -> torch.Tensor:
    """The (G,) per-client weight vector of a participation mask: a plain
    (G,) tensor passes through, a weighted mask ``{"w", "den", "n"}``
    (``fed.participation.ImportanceParticipation``) gives its ``"w"``.  A
    weight of 0 means "not sampled" in both forms."""
    return mask["w"] if isinstance(mask, dict) else mask


def masked_mean(x: torch.Tensor, mask=None) -> torch.Tensor:
    """Mean of ``x`` over its leading (client) axis, restricted to ``mask``.

    ``mask=None`` is the sum over clients divided by G.  A (G,) 0/1 mask
    divides the masked sum by ``max(sum(mask), 1)``, so an all-ones mask
    gives the unmasked result bit for bit: ``1.0 * x`` is exact, the sum
    runs in the same order, and the denominator is the same float G.  A
    weighted mask divides ``sum(w * x)`` by its STATIC denominator
    ``"den"``, the Horvitz-Thompson form (dividing by the random weight sum
    would make the unbiased estimator a ratio estimator)."""
    if mask is None:
        return torch.sum(x, dim=0) / x.shape[0]
    w = mask_weights(mask)
    m = w.reshape(w.shape + (1,) * (x.dim() - 1)).to(x.dtype)
    if isinstance(mask, dict):
        return torch.sum(x * m, dim=0) / float(mask["den"])
    den = torch.clamp(torch.sum(w), min=1.0).to(x.dtype)
    return torch.sum(x * m, dim=0) / den


def masked_mean_tree(tree: Tree, mask=None) -> dict[str, torch.Tensor]:
    """``masked_mean`` over every leaf (leaves have leading client axis G)."""
    return {k: masked_mean(x, mask) for k, x in tree.items()}


def masked_where_tree(mask, new: Tree, old: Tree) -> Tree:
    """Per-client state select: sampled clients take ``new`` leaves, the
    rest keep ``old`` (leaves (G, ...)).  ``mask=None`` (and, bit for bit,
    an all-ones mask) returns ``new``; weighted masks select on ``w > 0``."""
    if mask is None:
        return new
    w = mask_weights(mask)
    return {k: torch.where(w.reshape(w.shape + (1,) * (n.dim() - 1)) > 0,
                           n, old[k])
            for k, n in new.items()}


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


def client_deltas(cfg: SAFLConfig, loss_fn: LossFn, params: Tree,
                  batch: Mapping[str, torch.Tensor], eta: float,
                  clip=None) -> tuple[dict, torch.Tensor]:
    """Every client's delta (``clip`` applied to each, when given), stacked
    into (G, ...) leaves, and the (G,) losses."""
    g = next(iter(batch.values())).shape[0]
    deltas, losses = [], []
    for c in range(g):
        d, l = client_delta(cfg, loss_fn, params,
                            {k: v[c] for k, v in batch.items()}, eta)
        deltas.append(d if clip is None else clip(d))
        losses.append(l)
    stacked = {k: torch.stack([d[k] for d in deltas]) for k in params}
    return stacked, torch.stack(losses)


def _f32(x: float) -> float:
    return float(torch.tensor(x, dtype=torch.float32))


def sketched_cohort_update(sketch: SketchConfig, plan: Optional[PackingPlan],
                           params: Tree, deltas: Tree, round_key: prng.Key,
                           part_mask=None) -> dict[str, torch.Tensor]:
    """The uplink of one sketched round: sketch the stacked (G, ...) deltas
    with the round's shared operator into one (G, b_total) payload, take
    the cohort mean and desketch it into the server's update."""
    device = next(iter(params.values())).device
    if plan is None:
        plan = make_packing_plan(sketch, params)
    rp = derive_round_params(plan, round_key, device)
    mbar = masked_mean(sk_packed_clients(plan, rp, deltas), part_mask)
    return desk_packed(plan, rp, mbar)


def safl_round(cfg: SAFLConfig, loss_fn: LossFn, params: Tree,
               opt_state: dict, batch: Mapping[str, torch.Tensor],
               round_key: prng.Key, eta_scale: float = 1.0,
               lr_scale: float = 1.0, *,
               plan: Optional[PackingPlan] = None,
               part_mask=None) -> tuple[dict, dict, dict]:
    """One full SAFL round.  ``batch`` leaves are shaped (G, K, mb, ...).
    ``plan`` is the static packing layout (built once by multi-round
    callers).  ``part_mask`` (optional, (G,) 0/1 or the weighted dict)
    restricts the server's mean to the round's sampled cohort; an all-ones
    mask is bit for bit the full-participation round.  Returns (params,
    opt_state, metrics)."""
    eta = _f32(cfg.client_lr * eta_scale)
    deltas, losses = client_deltas(cfg, loss_fn, params, batch, eta)
    update = sketched_cohort_update(cfg.sketch, plan, params, deltas,
                                    round_key, part_mask)
    del deltas
    new_params, new_opt = apply_update(cfg.server, opt_state, params, update,
                                       lr_scale=lr_scale)
    return new_params, new_opt, {"loss": masked_mean(losses, part_mask)}


def fedopt_round(cfg: SAFLConfig, loss_fn: LossFn, params: Tree,
                 opt_state: dict, batch: Mapping[str, torch.Tensor],
                 round_key: prng.Key, eta_scale: float = 1.0,
                 lr_scale: float = 1.0, *,
                 part_mask=None) -> tuple[dict, dict, dict]:
    """Uncompressed FedOPT (Reddi et al. 2020) round: the paper's
    ambient-dimension reference line.  ``safl_round`` with the identity
    compressor: the server steps on the cohort mean of the raw deltas
    (``round_key`` is unused; it keeps the round signature)."""
    eta = _f32(cfg.client_lr * eta_scale)
    deltas, losses = client_deltas(cfg, loss_fn, params, batch, eta)
    update = masked_mean_tree(deltas, part_mask)
    del deltas
    params, opt_state = apply_update(cfg.server, opt_state, params, update,
                                     lr_scale=lr_scale)
    return params, opt_state, {"loss": masked_mean(losses, part_mask)}


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
