"""Communication-efficient FL baselines the paper compares against (§5,
Table 1), in PyTorch.

Counterpart of ``repro/core/baselines.py``.  Every baseline shares the
SAFL round interface:

    baseline_round(cfg, loss_fn, params, state, batch(G, K, mb, ...), key)
        -> (params, state, metrics)

  * ``fedavg``      -- plain local-SGD averaging (uncompressed, server SGD)
  * ``fedopt``      -- uncompressed adaptive server (Reddi et al. 2020)
  * ``topk_ef``     -- Top-K sparsification + client error feedback
                       (Stich et al. 2018); ``cdadam`` runs the same round
  * ``fetchsgd``    -- Count-Sketch uplink, server sketch-momentum + sketch
                       error accumulation + heavy-hitter Top-K unsketch
                       (Rothchild et al. 2020), the sketch re-keyed each
                       round as in the reference
  * ``onebit_adam`` -- Adam warmup, then frozen-variance sign compression
                       with error feedback (Tang et al. 2021)
  * ``marina``      -- unbiased compressed gradient differences with periodic
                       full sync (Gorbunov et al. 2021a), Bernoulli Rand-p
  * ``cocktail``    -- simplified CocktailSGD (Wang et al. 2023): Bernoulli
                       Rand-p then sign quantization, in error feedback

Rounds are plain functions on ``dict[str, Tensor]`` trees: the input state
is never mutated, a fresh dict comes back, so a round is a safe carry of
``launch.driver.run_scan``.  The device is the parameters'; keys are host
``prng.Key`` pairs, so the reference's draws (``bernoulli``, ``choice``)
come out bit for bit.  The reference vmaps its clients; the port loops
over them (``safl.client_deltas``) and over per-client draws.  The
reference's ``jax.lax.cond``s become:

  * onebit_adam: both branches are computed and ``torch.where`` selects on
    ``state["round"] < onebit_warmup``, a device scalar, so no round waits
    for the device to tell the host which branch to run (both branches are
    elementwise over the parameters and the (G, ...) error memory);
  * marina: the full-sync draw is ``bernoulli(key, marina_p)`` on the host
    (a key is host data), so only the branch taken runs, and a full-sync
    round skips the clients' pass at x_{t-1}.

The reference's ``telemetry=`` probes come with the port's ``obs`` module.
Python scalars that meet float32 tensors (``n / k``, ``1 / p``, the
shrink ``b / n``, ``eta``) are rounded to float32 first, as jax rounds
weak-typed scalars.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.adaptive import AdaConfig, apply_update, init_opt_state
from repro_torch.core.packed import (PackingPlan, derive_round_params,
                                     desk_flat, make_packing_plan, pack_rows,
                                     sk_flat, sk_packed_clients, unpack_rows,
                                     unpack_tree)
from repro_torch.core.safl import (SAFLConfig, client_deltas, mask_weights,
                                   masked_mean, masked_mean_tree,
                                   masked_where_tree)
from repro_torch.core.sketch import (SketchConfig, leaf_names, numel,
                                     total_sketch_bits)

Tree = Mapping[str, torch.Tensor]
LossFn = Callable[[Tree, Any], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class BaselineConfig:
    name: str = "fedavg"
    client_lr: float = 0.1
    local_steps: int = 1
    server: AdaConfig = AdaConfig(name="sgd", lr=1.0)
    remat_local: bool = True        # as SAFLConfig's: no effect on values or memory
    # compression knobs
    topk_ratio: float = 0.01        # fraction of coords kept (topk/randk)
    sketch: SketchConfig = SketchConfig(kind="countsketch", ratio=0.01)
    fetchsgd_momentum: float = 0.9
    fetchsgd_shrink: float = 0.0    # heavy-hitter shrinkage; 0 = auto (b/n)
    onebit_warmup: int = 10
    marina_p: float = 0.1           # prob of full-gradient sync round

    def _safl(self) -> SAFLConfig:
        return SAFLConfig(client_lr=self.client_lr,
                          local_steps=self.local_steps,
                          remat_local=self.remat_local)


def _f32(x: float) -> float:
    return float(np.float32(x))


# ---------------------------------------------------------------------------
# compressors (per flat vector; leading axes are independent rows)
# ---------------------------------------------------------------------------

def kth_largest_abs(v: torch.Tensor, k: int) -> torch.Tensor:
    """Exact k-th largest of |v| along the last axis, without a sort.

    Non-negative float32 values order exactly like their int32 bit
    patterns, so a 32-step binary search on the bit value -- each step one
    count -- finds the threshold ``top_k(|v|, k)[0][-1]``, the reference's
    search step for step.  ``lo``/``hi`` stay on the device: no step waits
    for the host."""
    xi = torch.abs(v.to(torch.float32)).view(torch.int32)
    lo = torch.amin(xi, dim=-1, keepdim=True)
    hi = torch.amax(xi, dim=-1, keepdim=True)
    for _ in range(32):
        mid = lo + torch.div(hi - lo + 1, 2, rounding_mode="floor")
        ok = torch.sum(xi >= mid, dim=-1, keepdim=True) >= k   # monotone in mid
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid - 1)
    return lo.view(torch.float32).squeeze(-1)


def topk_mask(v: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k largest-|.| entries of each row (ties at the threshold
    all kept), zero the rest (biased, contractive)."""
    k = max(1, min(int(k), v.shape[-1]))
    thresh = kth_largest_abs(v, k)
    return torch.where(torch.abs(v) >= thresh.unsqueeze(-1), v, 0.0)


def randk_unbiased(key: prng.Key, v: torch.Tensor, k: int) -> torch.Tensor:
    """Unbiased Rand-K: keep k random coords scaled by n/k (omega = n/k - 1);
    the coords are ``prng.choice(key, n, (k,))``, drawn without
    replacement."""
    n = v.shape[0]
    k = max(1, min(int(k), n))
    idx = prng.choice(key, n, (k,), v.device)
    mask = torch.zeros(n, dtype=v.dtype, device=v.device).index_fill_(0, idx, 1.0)
    return v * mask * _f32(n / k)


def randp_unbiased(key: prng.Key, v: torch.Tensor, p: float) -> torch.Tensor:
    """Unbiased Bernoulli Rand-p: keep each coord w.p. ``p``, scale by 1/p
    (the omega of Rand-K at p = k/n, in one pass)."""
    mask = prng.bernoulli(key, p, v.shape, v.device)
    return torch.where(mask, v / _f32(p), 0.0)


def sign_quant(v: torch.Tensor) -> torch.Tensor:
    """1-bit sign quantization with l1 scale (1bit-Adam / signSGD style),
    each row of the last axis scaled by its own mean |.|."""
    return torch.sign(v) * torch.mean(torch.abs(v), dim=-1, keepdim=True)


def _per_leaf(fn, tree: Tree) -> dict[str, torch.Tensor]:
    """``fn(i, flat leaf)`` over the leaves in the reference's leaf order,
    reshaped back."""
    return {name: fn(i, tree[name].reshape(-1)).reshape(tree[name].shape)
            for i, name in enumerate(leaf_names(tree))}


def _select(cond: torch.Tensor, a, b):
    """``torch.where(cond, a, b)`` leaf by leaf over matching nested dicts."""
    if isinstance(a, Mapping):
        return {k: _select(cond, a[k], b[k]) for k in a}
    return torch.where(cond, a, b)


def _sketch_momentum(cfg: BaselineConfig, state: dict, sks: torch.Tensor,
                     part_mask) -> tuple[torch.Tensor, torch.Tensor]:
    """FetchSGD's server in sketch space: the cohort mean of the (G, b_total)
    client sketches into the momentum, the momentum into the error
    accumulator.  Returns (momentum, error accumulator)."""
    s_mean = masked_mean(sks.to(torch.float32), part_mask)
    mom = _f32(cfg.fetchsgd_momentum) * state["sk_mom"] + s_mean
    return mom, state["sk_err"] + mom


def _heavy_hitters(cfg: BaselineConfig, plan: PackingPlan,
                   dense: torch.Tensor) -> torch.Tensor:
    """FetchSGD's update from the desketched (d_total,) error: each op's
    top-k, shrunk by ~b/n (a desketch's top-k picks upward-biased
    coordinates, so the shrink makes the applied mass match the signal)."""
    parts = []
    for op in plan.ops:
        k = max(1, int(op.n * cfg.topk_ratio))
        shrink = _f32(cfg.fetchsgd_shrink or min(1.0, op.b / op.n))
        parts.append(topk_mask(dense[op.in_off:op.in_off + op.n], k) * shrink)
    return torch.cat(parts)


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------

def init_baseline_state(cfg: BaselineConfig, params: Tree, num_clients: int,
                        plan: Optional[PackingPlan] = None) -> dict:
    """The server optimizer state, ``round`` (an int32 device scalar) and
    the variant's memories, on the parameters' device."""
    device = next(iter(params.values())).device
    f32 = lambda t: {k: torch.zeros(p.shape, dtype=torch.float32, device=device)
                     for k, p in t.items()}
    state = {"opt": init_opt_state(cfg.server, params),
             "round": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.name in ("topk_ef", "onebit_adam", "cocktail", "cdadam"):
        # per-client error memories
        state["err"] = {k: torch.zeros((num_clients,) + tuple(p.shape),
                                       dtype=torch.float32, device=device)
                        for k, p in params.items()}
    if cfg.name == "fetchsgd":
        # sketch-space accumulators live in the packed (b_total,) payload
        if plan is None:
            plan = make_packing_plan(cfg.sketch, params)
        state["sk_mom"] = torch.zeros(plan.b_total, dtype=torch.float32, device=device)
        state["sk_err"] = torch.zeros(plan.b_total, dtype=torch.float32, device=device)
    if cfg.name == "marina":
        state["g"] = f32(params)
        state["prev_params"] = {k: p.to(torch.float32, copy=True)
                                for k, p in params.items()}
    if cfg.name == "onebit_adam":
        state["v_frozen"] = f32(params)
    return state


# ---------------------------------------------------------------------------
# rounds
# ---------------------------------------------------------------------------

def baseline_round(cfg: BaselineConfig, loss_fn: LossFn, params: Tree,
                   state: dict, batch: Mapping[str, torch.Tensor],
                   key: prng.Key, *, plan: Optional[PackingPlan] = None,
                   part_mask=None, telemetry=None) -> tuple[dict, dict, dict]:
    """One baseline round; ``batch`` leaves are (G, K, mb, ...).  The input
    ``state`` is never mutated.  ``plan`` is the static packing layout,
    built once by multi-round callers.  ``part_mask`` (optional, (G,) 0/1
    or the weighted dict) restricts the server aggregation to the round's
    sampled cohort: unsampled clients transmit nothing, their error-feedback
    memories stay frozen, and an all-ones mask is bit for bit no mask.
    ``telemetry`` (``obs.Telemetry``) adds the cohort-mean delta norm, the
    effective cohort, the moment norms and, where the variant carries one,
    the error-feedback memory's norm; no update or residual probe (most
    baselines apply a biased compressed update, so the desketch residual
    is not their observable)."""
    eta = _f32(cfg.client_lr)
    rnd = state["round"]
    device = next(iter(params.values())).device
    scfg = cfg._safl()
    deltas, losses = client_deltas(scfg, loss_fn, params, batch, eta)
    probe_deltas = deltas if telemetry is not None else None
    metrics = {"loss": masked_mean(losses, part_mask)}
    g = next(iter(deltas.values())).shape[0]

    if cfg.name in ("fedavg", "fedopt"):
        update = masked_mean_tree(deltas, part_mask)
        params, opt = apply_update(cfg.server, state["opt"], params, update)
        state = {**state, "opt": opt}

    elif cfg.name in ("topk_ef", "cocktail", "cdadam"):
        # error memory + delta packed into one (G, d_total) buffer; the
        # compressor runs once per client row over the whole vector (global
        # top-k / rand-p)
        if plan is None:
            plan = make_packing_plan(cfg.sketch, params)
        a2 = pack_rows(plan, {k: state["err"][k] + d for k, d in deltas.items()})
        del deltas
        k = max(1, int(plan.d_total * cfg.topk_ratio))
        if cfg.name == "cocktail":
            rows = []
            for c in range(g):
                # biased Bernoulli Rand-p, p = k/n (expected-k; EF absorbs
                # the bias), then sign-quantize the survivors (scale = mean
                # |.| over the kept)
                mask = prng.bernoulli(prng.fold_in(key, c), k / plan.d_total,
                                      (plan.d_total,), device)
                sparse = torch.where(mask, a2[c], 0.0)
                kept = torch.clamp(torch.sum(mask), min=1).to(torch.float32)
                rows.append(torch.sign(sparse) * (torch.sum(torch.abs(sparse)) / kept))
            comp = torch.stack(rows)
        else:
            comp = topk_mask(a2, k)
        err_flat = a2 - comp
        del a2
        if part_mask is not None:
            # unsampled clients never compressed or transmitted: their error
            # memory is untouched this round
            sel = mask_weights(part_mask).reshape(-1, 1) > 0
            err_flat = torch.where(sel, err_flat, pack_rows(plan, state["err"]))
        update = unpack_tree(plan, masked_mean(comp, part_mask), cast=False)
        params, opt = apply_update(cfg.server, state["opt"], params, update)
        state = {**state, "err": unpack_rows(plan, err_flat), "opt": opt}

    elif cfg.name == "fetchsgd":
        # the sketch is re-keyed every round (the reference's note: a fixed
        # sketch needs the heavy-hitter assumption and diverges on dense
        # gradients); momentum and error accumulate in the (b_total,) payload
        if plan is None:
            plan = make_packing_plan(cfg.sketch, params)
        rp = derive_round_params(plan, key, device)
        sks = sk_packed_clients(plan, rp, deltas)           # (G, b_total)
        del deltas
        mom, er = _sketch_momentum(cfg, state, sks, part_mask)
        dense = desk_flat(plan, rp, er)                     # unsketch error acc
        upd_flat = _heavy_hitters(cfg, plan, dense)
        er = er - sk_flat(plan, rp, upd_flat).to(torch.float32)
        update = unpack_tree(plan, upd_flat, cast=False)
        params, opt = apply_update(cfg.server, state["opt"], params, update)
        state = {**state, "sk_mom": mom, "sk_err": er, "opt": opt}

    elif cfg.name == "onebit_adam":
        srv = cfg.server
        mean_delta = masked_mean_tree(deltas, part_mask)
        warm = rnd < cfg.onebit_warmup
        # warmup: the server's own step, tracking the variance to freeze
        p_w, opt_w = apply_update(srv, state["opt"], params, mean_delta)
        vf_w = {k: srv.beta2 * v + (1 - srv.beta2) * mean_delta[k] * mean_delta[k]
                for k, v in state["v_frozen"].items()}
        # compressed: per-client sign compression with EF, frozen variance
        a = {k: state["err"][k] + d for k, d in deltas.items()}
        c = {k: sign_quant(x.reshape(g, -1)).reshape(x.shape) for k, x in a.items()}
        err_c = masked_where_tree(part_mask, {k: a[k] - c[k] for k in a},
                                  state["err"])
        u = masked_mean_tree(c, part_mask)
        m_c = {k: srv.beta1 * m + (1 - srv.beta1) * u[k]
               for k, m in state["opt"]["m"].items()}
        p_c = {k: (p - srv.lr * (m_c[k] / (torch.sqrt(state["v_frozen"][k]) + srv.eps)))
               .to(p.dtype) for k, p in params.items()}
        opt_c = {**state["opt"], "m": m_c, "step": state["opt"]["step"] + 1}
        params = _select(warm, p_w, p_c)
        state = {**state, "opt": _select(warm, opt_w, opt_c),
                 "v_frozen": _select(warm, vf_w, state["v_frozen"]),
                 "err": _select(warm, state["err"], err_c)}

    elif cfg.name == "marina":
        # gradient-difference compression; K=1 semantics: delta/eta = grad
        grads = {k: d / eta for k, d in deltas.items()}     # (G, shape)
        if bool(prng.bernoulli(key, cfg.marina_p, (), "cpu")):
            g_new = masked_mean_tree(grads, part_mask)
        else:
            # the clients' gradients at x_{t-1} on the same minibatch; one
            # (G, d_total) buffer, one Bernoulli Rand-p draw per client
            if plan is None:
                plan = make_packing_plan(cfg.sketch, params)
            prev = {k: state["prev_params"][k].to(p.dtype) for k, p in params.items()}
            prev_deltas, _ = client_deltas(scfg, loss_fn, prev, batch, eta)
            flat = pack_rows(plan, {k: grads[k] - d / eta
                                     for k, d in prev_deltas.items()})
            comp = torch.stack([randp_unbiased(prng.fold_in(key, c), flat[c],
                                               cfg.topk_ratio) for c in range(g)])
            q = unpack_tree(plan, masked_mean(comp, part_mask), cast=False)
            g_new = {k: v + q[k] for k, v in state["g"].items()}
        prev = {k: p.to(torch.float32) for k, p in params.items()}
        params, opt = apply_update(cfg.server, state["opt"], params, g_new)
        state = {**state, "g": g_new, "prev_params": prev, "opt": opt}

    else:
        raise ValueError(f"unknown baseline {cfg.name}")

    new_state = {**state, "round": rnd + 1}
    if telemetry is not None:
        from repro_torch.obs.telemetry import telemetry_probes
        metrics.update(telemetry_probes(telemetry, deltas=probe_deltas,
                                        part_mask=part_mask, state=new_state))
    return params, new_state, metrics


def uplink_bits(cfg: BaselineConfig, params: Mapping[str, Any]) -> int:
    """Approximate per-client uplink bits per round, for Table 1 parity
    (``params``: anything with ``.shape``)."""
    n = sum(numel(tuple(p.shape)) for p in params.values())
    if cfg.name in ("fedavg", "fedopt"):
        return n * 32
    if cfg.name in ("topk_ef", "cdadam"):
        k = int(n * cfg.topk_ratio)
        return k * (32 + 32)  # value + index
    if cfg.name == "cocktail":
        k = int(n * cfg.topk_ratio)
        return k * (1 + 32)   # sign bit + index
    if cfg.name == "fetchsgd":
        return total_sketch_bits(cfg.sketch, params)
    if cfg.name == "onebit_adam":
        return n * 1
    if cfg.name == "marina":
        k = int(n * cfg.topk_ratio)
        return int(cfg.marina_p * n * 32 + (1 - cfg.marina_p) * k * 64)
    raise ValueError(cfg.name)
