"""SAFL: Sketched Adaptive Federated Learning (paper Algorithm 1), in PyTorch.

Counterpart of ``repro/core/safl.py``: the materialized round, the
streamed fold over client microbatches (``microbatch=``) and the
uncompressed FedOPT round, with the federated hooks ``part_mask``,
``fault_spec``, ``sentinel`` and ``codec`` (``repro_torch.fed``), and the
``telemetry`` probes (``repro_torch.obs``).  One round:

  1. every client starts from the global iterate and runs K local SGD
     steps with client lr eta;
  2. its delta x_0 - x_K is sketched with the round's shared operator
     into one ``(G, b_total)`` payload (``core.packed``);
  3. the server averages the G sketches (by linearity, the sketch of the
     mean delta), desketches the mean and takes one ADA_OPT step.

The reference vmaps the clients; the port loops over them and stacks the
deltas into the same ``(G, ...)`` leaves.  Under partial participation
every client still computes (static shapes, as in the reference's
simulation); the mask decides what the server averages.  The streamed
fold keeps one chunk of deltas and payload rows at a time.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional

import torch
import torch.distributed as dist

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
    # the reference's jax.checkpoint around the local value_and_grad, which
    # nothing differentiates: it changes neither values nor memory there
    # (the blocks' own recompute is the model's ``remat``)
    remat_local: bool = True


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


def masked_psum_mean(x: torch.Tensor, w_loc: torch.Tensor, den,
                     group=None) -> torch.Tensor:
    """``masked_mean`` distributed over the ranks of a client process group.

    ``x`` is a rank's ``(G_loc, ...)`` block of the client-major payload
    and ``w_loc`` the matching ``(G_loc,)`` slice of the cohort weights.
    The weighted local sum over the rank's client rows crosses ONE
    ``all_reduce`` over ``group`` (plus the scalar weight sum when ``den``
    is None), then divides.  Returns a ``(1, ...)`` row, the same on every
    rank; ``group=None`` (no client axes) reduces nothing.

    ``den=None`` divides by the global weight sum (the 0/1-mask cohort
    mean); a static ``den`` is the Horvitz-Thompson denominator of a
    weighted mask.  With an all-ones mask and one client row a rank this
    is ``all_reduce(x) / n`` exactly: ``1.0 * x`` is exact, the row sum of
    one row is the row, and the weight sum is the float n."""
    w = w_loc.reshape((w_loc.shape[0],) + (1,) * (x.dim() - 1)).to(x.dtype)
    sw = torch.sum(x * w, dim=0, keepdim=True)
    if den is None:
        wsum = torch.sum(w_loc).to(torch.float32)
        if group is not None:
            dist.all_reduce(sw, group=group)
            dist.all_reduce(wsum, group=group)
        return sw / torch.clamp(wsum, min=1.0).to(x.dtype)
    if group is not None:
        dist.all_reduce(sw, group=group)
    return sw / float(den)


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
    """A Python float rounded to float32, as jax rounds a weakly typed
    scalar before it meets a float32 array."""
    return float(torch.tensor(x, dtype=torch.float32))


def _device(tree: Tree) -> torch.device:
    return next(iter(tree.values())).device


def _unwrap_ef(codec, opt_state: dict) -> tuple[dict, Optional[torch.Tensor]]:
    """(server state, EF memory): with ``codec.error_feedback`` the round
    state is the wrapped ``{"opt", "ef"}`` dict."""
    if codec is not None and codec.error_feedback:
        return opt_state["opt"], opt_state["ef"]
    return opt_state, None


def sketched_round(cfg: SAFLConfig, client_fn, params: Tree, opt_state: dict,
                   batch, round_key: prng.Key, *, lr_scale: float = 1.0,
                   plan: Optional[PackingPlan] = None, part_mask=None,
                   fault_spec=None, sentinel=None, codec=None, telemetry=None,
                   triggers: Optional[list] = None) -> tuple[dict, dict, dict]:
    """A materialized sketched round: ``client_fn(batch) -> (deltas,
    losses)`` gives the stacked (G, ...) deltas and (G,) losses, and the
    server half follows the reference's order: the sketch with the round's
    shared operator; the codec (decode before any vetting, with the EF
    memory of unsampled clients frozen); the fault and sentinel guard
    (``fed.robust.guard_uplink``); the one masked mean; the desk;
    ``apply_update``; the measured uplink bits; the empty-cohort carry and
    the divergence flag; then, with ``telemetry``, the probes from the
    deltas, the update, the effective mask and the new state (and the
    clip share of ``triggers``, the (G,) list of clip triggers ``client_fn``
    fills for SACFL).  A hook left ``None`` is skipped in Python; without
    telemetry the deltas are freed right after the sketch."""
    device = _device(params)
    opt_orig = opt_state
    opt_state, ef = _unwrap_ef(codec, opt_state)
    if plan is None:
        plan = make_packing_plan(cfg.sketch, params)
    deltas, losses = client_fn(batch)
    rp = derive_round_params(plan, round_key, device)
    sketches = sk_packed_clients(plan, rp, deltas)
    probe_deltas = deltas if telemetry is not None else None
    del deltas
    if codec is not None:
        from repro_torch.fed.codec import encode_decode
        sketches, ef_new = encode_decode(codec, round_key,
                                         sketches.to(torch.float32), ef_rows=ef)
        if ef is not None:
            ef = masked_where_tree(part_mask, {"ef": ef_new}, {"ef": ef})["ef"]
    counters = {}
    if fault_spec is not None or sentinel is not None:
        from repro_torch.fed.robust import guard_uplink
        sketches, part_mask, counters = guard_uplink(sketches, part_mask,
                                                     fault_spec, sentinel)
    update = desk_packed(plan, rp, masked_mean(sketches, part_mask))
    del sketches
    new_params, new_opt = apply_update(cfg.server, opt_state, params, update,
                                       lr_scale=lr_scale)
    if ef is not None:
        new_opt = {"opt": new_opt, "ef": ef}
    if codec is not None:
        from repro_torch.fed.codec import measured_uplink_bits
        counters["uplink_bits"] = measured_uplink_bits(
            codec, plan.b_total, eff_mask=part_mask,
            num_clients=losses.shape[0], device=device)
    loss = masked_mean(losses, part_mask)
    if sentinel is not None:
        from repro_torch.fed.robust import carry_if_empty, divergence_flag
        # the wrapped EF memory reverts with the server state on an empty
        # cohort, as in the reference
        new_params, new_opt = carry_if_empty(part_mask, (new_params, new_opt),
                                             (params, opt_orig))
        counters["diverged"] = divergence_flag(sentinel, loss)
    metrics = {"loss": loss, **counters}
    if telemetry is not None:
        # part_mask is the effective mask here (the guard rebinds it), so
        # the probes see the cohort the mean saw
        from repro_torch.obs.telemetry import telemetry_probes
        metrics.update(telemetry_probes(
            telemetry, deltas=probe_deltas, update=update, part_mask=part_mask,
            state=new_opt, clip_frac=None if triggers is None
            else masked_mean(torch.stack(triggers), part_mask)))
    return new_params, new_opt, metrics


_STREAMED_TELEMETRY = (
    "telemetry probes read the materialized (G, ...) delta stack; the "
    "streamed microbatch fold never builds it: run telemetry with "
    "microbatch=None")
_CODEC_TELEMETRY = (
    "telemetry probes read the bare server opt state; under "
    "codec.error_feedback the round state is the wrapped {'opt', 'ef'} "
    "dict: run telemetry without a codec")


# ---------------------------------------------------------------------------
# the streamed client-microbatch fold
# ---------------------------------------------------------------------------

def resolve_microbatch(microbatch, num_clients: int) -> Optional[int]:
    """``None``, or a chunk covering the whole cohort, selects the
    materialized round (a fold of one chunk is that round, so it routes in
    Python and stays bit for bit the hookless program); a chunk size below
    ``num_clients`` selects the streamed fold, its own program family."""
    if microbatch is None:
        return None
    mb = int(microbatch)
    if mb <= 0:
        raise ValueError(f"microbatch must be a positive int, got {microbatch}")
    return None if mb >= num_clients else mb


def chunk_clients(tree: Tree, mb: int, pad: int) -> dict[str, torch.Tensor]:
    """Zero-pad the leading client axis by ``pad`` rows and reshape every
    leaf to ``(n_mb, mb, ...)`` chunks."""
    def f(x):
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        return x.reshape((-1, mb) + tuple(x.shape[1:]))
    return {k: f(v) for k, v in tree.items()}


def _pad_fault_spec(spec: dict, pad: int) -> dict:
    """Extend a (G,) fault spec by ``pad`` neutral rows (arrive, honest
    scale, no corruption), which keep a pad client's zero payload finite."""
    if not pad:
        return spec
    neutral = {"arrive": 1.0, "nan": False, "inf": False, "scale": 1.0}
    return {k: torch.cat([v, torch.full((pad,), neutral[k], dtype=v.dtype,
                                        device=v.device)])
            for k, v in spec.items()}


def _num_clients(batch: Mapping[str, torch.Tensor]) -> int:
    return next(iter(batch.values())).shape[0]


def streamed_sketch_round(cfg: SAFLConfig, client_fn, params: Tree,
                          opt_state: dict, batch, round_key: prng.Key,
                          mb: int, *, lr_scale: float = 1.0,
                          plan: Optional[PackingPlan] = None, part_mask=None,
                          fault_spec=None, sentinel=None,
                          codec=None) -> tuple[dict, dict, dict]:
    """One sketched round as a fold over chunks of ``mb`` clients.

    ``client_fn(batch_chunk) -> (deltas, losses)`` computes a chunk's
    stacked (r, ...) deltas and (r,) losses.  Each chunk is sketched with
    the round's shared operator and reduced at once into the running
    ``(b_total,)`` weighted payload sum, weight sum and loss sum, and its
    deltas and payload are freed before the next chunk starts, so the
    payload held is ``(mb, b_total)`` whatever G.  By linearity the sum of
    the chunk sums is the sketch of the weighted delta sum, so the one desk
    sees the materialized round's cohort mean up to float32 summation
    order.

    The hooks act per chunk on the GLOBAL client rows (the participation
    weights, the fault spec, the codec's row keys and EF rows), in the
    reference's order: codec, faults, sentinel, mask.  The norm-outlier
    sentinel's median is a statistic of the whole cohort, so
    ``norm_mult > 0`` folds twice: pass 1 keeps each client's loss, squared
    norm, finite verdict and weight; pass 2 recomputes the same payloads
    (every step is a pure function of the params, batch, operator and key)
    and sums them under the final weights.

    The tail chunk's pad clients (``G % mb``) run no client: zero payload
    rows of weight 0 stand in their place, as the reference's static
    zeroing produces.  With ``codec.error_feedback`` ``opt_state`` is the
    wrapped ``{"opt", "ef"}`` dict."""
    device = _device(params)
    if plan is None:
        plan = make_packing_plan(cfg.sketch, params)
    rp = derive_round_params(plan, round_key, device)
    opt_orig = opt_state
    opt_state, ef = _unwrap_ef(codec, opt_state)
    if codec is not None:
        from repro_torch.fed.codec import encode_decode
    if fault_spec is not None:
        from repro_torch.fed.faults import corrupt_payload, n_dropped

    g = _num_clients(batch)
    n_mb = -(-g // mb)
    pad = n_mb * mb - g
    w0 = (torch.ones(g, dtype=torch.float32, device=device) if part_mask is None
          else mask_weights(part_mask).to(torch.float32))
    xs = chunk_clients({"w": w0} if ef is None else {"w": w0, "ef": ef}, mb, pad)
    if fault_spec is not None:
        spec_c = chunk_clients(_pad_fault_spec(fault_spec, pad), mb, 0)

    def chunk_payload(i: int):
        """Chunk i's (mb, b_total) decoded, corrupted payload rows, its (mb,)
        losses and post-arrival weights, and its EF residual rows."""
        c0, c1 = i * mb, min((i + 1) * mb, g)
        deltas, losses = client_fn({k: v[c0:c1] for k, v in batch.items()})
        sks = sk_packed_clients(plan, rp, deltas).to(torch.float32)
        del deltas
        if c1 - c0 < mb:            # the tail's pad clients: zero rows
            sks = torch.cat([sks, sks.new_zeros((mb - (c1 - c0), sks.shape[1]))])
            losses = torch.cat([losses, losses.new_zeros(mb - (c1 - c0))])
        ef_c = None
        if codec is not None:
            sks, ef_c = encode_decode(codec, round_key, sks,
                                      ef_rows=None if ef is None else xs["ef"][i],
                                      client_ids=range(i * mb, (i + 1) * mb))
        w = xs["w"][i]
        if fault_spec is not None:
            spec = {k: v[i] for k, v in spec_c.items()}
            sks = corrupt_payload(spec, sks)
            w = w * spec["arrive"]
        return sks, losses, w, ef_c

    counters = {}
    if fault_spec is not None:
        counters["n_dropped"] = n_dropped(fault_spec, part_mask)
    zero = lambda: torch.zeros((), dtype=torch.float32, device=device)
    S = torch.zeros(plan.b_total, dtype=torch.float32, device=device)
    ef_rows = []
    if sentinel is None or sentinel.norm_mult == 0.0:
        # one pass: the finite check is row-local, so faults, sentinel and
        # mask fuse inside each chunk
        W, L, n_tx = zero(), zero(), zero()
        n_rej = torch.zeros((), dtype=torch.int64, device=device)
        for i in range(n_mb):
            sks, losses, w, ef_c = chunk_payload(i)
            if sentinel is not None:
                ok = torch.isfinite(sks).all(dim=-1)
                sks = torch.where(ok[:, None], sks, 0.0)
                n_rej = n_rej + torch.sum((w > 0) & ~ok)
                w = w * ok.to(torch.float32)
            S = S + torch.sum(sks * w[:, None], dim=0)
            W = W + torch.sum(w)
            L = L + torch.sum(w * losses)
            n_tx = n_tx + torch.sum((w > 0).to(torch.float32))
            ef_rows.append(ef_c)
            del sks
        if sentinel is not None:
            counters["n_rejected"] = n_rej.to(torch.int32)
    else:
        # two passes: the norm-outlier median needs the whole cohort's norms
        from repro_torch.fed.robust import masked_median, norm_bound
        stats = []
        for i in range(n_mb):
            sks, losses, w, ef_c = chunk_payload(i)
            ok = torch.isfinite(sks).all(dim=-1)
            clean = torch.where(ok[:, None], sks, 0.0)
            stats.append((losses, torch.sum(torch.square(clean), dim=-1), ok, w))
            ef_rows.append(ef_c)
            del sks, clean
        losses_p, nrm2_p, ok_p, w_arr = (torch.cat(c) for c in zip(*stats))
        med2 = masked_median(nrm2_p, (w_arr > 0) & ok_p)
        valid = ok_p & (nrm2_p <= norm_bound(sentinel, med2))
        counters["n_rejected"] = torch.sum((w_arr > 0) & ~valid).to(torch.int32)
        w_eff = w_arr * valid.to(torch.float32)
        n_tx = torch.sum((w_eff > 0).to(torch.float32))
        ok_c, we_c = ok_p.reshape(n_mb, mb), w_eff.reshape(n_mb, mb)
        for i in range(n_mb):
            sks = chunk_payload(i)[0]
            clean = torch.where(ok_c[i][:, None], sks, 0.0)
            S = S + torch.sum(clean * we_c[i][:, None], dim=0)
            del sks, clean
        W, L = torch.sum(w_eff), torch.sum(w_eff * losses_p)

    den = (float(part_mask["den"]) if isinstance(part_mask, dict)
           else torch.clamp(W, min=1.0))
    loss = L / den
    update = desk_packed(plan, rp, S / den)
    new_params, new_opt = apply_update(cfg.server, opt_state, params, update,
                                       lr_scale=lr_scale)
    if ef is not None:
        # unsampled clients (pre-fault weight 0) freeze their EF memory
        ef_new = torch.cat(ef_rows)[:g]
        new_opt = {"opt": new_opt, "ef": torch.where((w0 > 0)[:, None], ef_new, ef)}
    if codec is not None:
        counters["uplink_bits"] = (
            torch.tensor(float(codec.payload_bits(plan.b_total)),
                         dtype=torch.float32, device=device) * n_tx)
    if sentinel is not None:
        from repro_torch.fed.robust import carry_if_empty, divergence_flag
        # the surviving weight W is the effective mask's sum, all that
        # carry_if_empty reads
        new_params, new_opt = carry_if_empty(W, (new_params, new_opt),
                                             (params, opt_orig))
        counters["diverged"] = divergence_flag(sentinel, loss)
    return new_params, new_opt, {"loss": loss, **counters}


def safl_round(cfg: SAFLConfig, loss_fn: LossFn, params: Tree,
               opt_state: dict, batch: Mapping[str, torch.Tensor],
               round_key: prng.Key, eta_scale: float = 1.0,
               lr_scale: float = 1.0, *,
               plan: Optional[PackingPlan] = None, part_mask=None,
               fault_spec=None, sentinel=None, telemetry=None,
               microbatch=None, codec=None) -> tuple[dict, dict, dict]:
    """One full SAFL round.  ``batch`` leaves are shaped (G, K, mb, ...).
    ``plan`` is the static packing layout (built once by multi-round
    callers).  ``part_mask`` (optional, (G,) 0/1 or the weighted dict)
    restricts the server's mean to the round's sampled cohort; an all-ones
    mask is bit for bit the full-participation round.  ``fault_spec``
    (``fed.faults``) corrupts and drops payloads, ``sentinel``
    (``fed.robust.SentinelConfig``) rejects bad ones before the mean,
    ``codec`` (``fed.codec.CodecConfig``) quantizes the payload rows and
    bills the measured ``uplink_bits`` (with ``codec.error_feedback`` the
    state is the wrapped ``{"opt", "ef"}`` dict), ``telemetry``
    (``obs.Telemetry``) adds the probe scalars to the metrics, and
    ``microbatch`` below G streams the round over client chunks
    (``streamed_sketch_round``; it takes no telemetry).
    Returns (params, opt_state, metrics)."""
    if codec is not None and telemetry is not None:
        raise ValueError(_CODEC_TELEMETRY)
    eta = _f32(cfg.client_lr * eta_scale)
    client_fn = lambda b: client_deltas(cfg, loss_fn, params, b, eta)
    hooks = dict(plan=plan, part_mask=part_mask, fault_spec=fault_spec,
                 sentinel=sentinel, codec=codec)
    mb = resolve_microbatch(microbatch, _num_clients(batch))
    if mb is not None:
        if telemetry is not None:
            raise ValueError(_STREAMED_TELEMETRY)
        return streamed_sketch_round(cfg, client_fn, params, opt_state, batch,
                                     round_key, mb, lr_scale=lr_scale, **hooks)
    return sketched_round(cfg, client_fn, params, opt_state, batch, round_key,
                          lr_scale=lr_scale, telemetry=telemetry, **hooks)


def fedopt_round(cfg: SAFLConfig, loss_fn: LossFn, params: Tree,
                 opt_state: dict, batch: Mapping[str, torch.Tensor],
                 round_key: prng.Key, eta_scale: float = 1.0,
                 lr_scale: float = 1.0, *, part_mask=None, fault_spec=None,
                 sentinel=None, telemetry=None, microbatch=None,
                 codec=None) -> tuple[dict, dict, dict]:
    """Uncompressed FedOPT (Reddi et al. 2020) round: the paper's
    ambient-dimension reference line.  ``safl_round`` with the identity
    compressor: the server steps on the cohort mean of the raw deltas
    (``round_key`` is unused; it keeps the round signature).  It has no
    sketch payload, so faults, sentinels and the codec are refused;
    ``microbatch`` below G folds the raw deltas chunk by chunk.  Its
    update is the cohort mean itself, so with ``telemetry`` the
    ``residual`` probe reads exactly 0: the sketch-noise baseline."""
    if fault_spec is not None or sentinel is not None:
        raise ValueError(
            "fault injection and payload sentinels act on the packed sketch "
            "uplink (fed.faults, fed.robust); the uncompressed FedOPT "
            "baseline has no sketch payload: run them on the SAFL/SACFL rounds")
    if codec is not None:
        raise ValueError(
            "the payload codec quantizes the packed sketch uplink "
            "(fed.codec); the uncompressed FedOPT baseline has no sketch "
            "payload: run the codec on the SAFL/SACFL rounds")
    eta = _f32(cfg.client_lr * eta_scale)
    mb = resolve_microbatch(microbatch, _num_clients(batch))
    if mb is not None:
        if telemetry is not None:
            raise ValueError(_STREAMED_TELEMETRY)
        return _streamed_fedopt_round(cfg, loss_fn, params, opt_state, batch,
                                      eta, mb, lr_scale=lr_scale,
                                      part_mask=part_mask)
    deltas, losses = client_deltas(cfg, loss_fn, params, batch, eta)
    update = masked_mean_tree(deltas, part_mask)
    probe_deltas = deltas if telemetry is not None else None
    del deltas
    params, opt_state = apply_update(cfg.server, opt_state, params, update,
                                     lr_scale=lr_scale)
    metrics = {"loss": masked_mean(losses, part_mask)}
    if telemetry is not None:
        from repro_torch.obs.telemetry import telemetry_probes
        metrics.update(telemetry_probes(
            telemetry, deltas=probe_deltas, update=update, part_mask=part_mask,
            state=opt_state))
    return params, opt_state, metrics


def _streamed_fedopt_round(cfg: SAFLConfig, loss_fn: LossFn, params: Tree,
                           opt_state: dict, batch, eta: float, mb: int, *,
                           lr_scale: float = 1.0,
                           part_mask=None) -> tuple[dict, dict, dict]:
    """The streamed fold of the FedOPT round: the raw-delta mean is a plain
    weighted tree sum, so the fold carries one tree of the params' size
    and the weight and loss sums instead of the (G, ...) delta stack.  The
    tail chunk is short: adding zero rows of weight 0 would change no sum
    (tests/test_torch_stream.py holds a padded chunk to a short one)."""
    device = _device(params)
    g = _num_clients(batch)
    w0 = (torch.ones(g, dtype=torch.float32, device=device) if part_mask is None
          else mask_weights(part_mask).to(torch.float32))
    S = {k: torch.zeros(p.shape, dtype=torch.float32, device=device)
         for k, p in params.items()}
    W = L = torch.zeros((), dtype=torch.float32, device=device)
    for c0 in range(0, g, mb):
        c1 = min(c0 + mb, g)
        deltas, losses = client_deltas(cfg, loss_fn, params,
                                       {k: v[c0:c1] for k, v in batch.items()},
                                       eta)
        w = w0[c0:c1]
        S = {k: s + torch.sum(deltas[k] * w.reshape((-1,) + (1,) * (s.dim())),
                              dim=0) for k, s in S.items()}
        W = W + torch.sum(w)
        L = L + torch.sum(w * losses)
        del deltas
    den = (float(part_mask["den"]) if isinstance(part_mask, dict)
           else torch.clamp(W, min=1.0))
    params, opt_state = apply_update(cfg.server, opt_state, params,
                                     {k: s / den for k, s in S.items()},
                                     lr_scale=lr_scale)
    return params, opt_state, {"loss": L / den}


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
