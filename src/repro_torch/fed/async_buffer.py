"""FedBuff-style async staleness buffer for SAFL/SACFL rounds.

Counterpart of ``repro/fed/async_buffer.py``.  A client's update lands at
the server rounds after the model it was computed against:

* every round, the clients sketch their deltas with the round's operator
  and the ``(G, b_total)`` payload is pushed into a ring of the last
  D = ``max_delay + 1`` generations, held in the round state
  (``state["buf"]``/``state["bufw"]``);
* a deterministic delay policy gives client c of generation g a delay
  ``d(g, c)`` in ``[0, max_delay]``, a pure function of ``(g, c, seed)``,
  so arrivals are recomputed at pop time and only the payloads are stored;
* at round t the server pops what arrives now (generation ``g = t - d``
  with delay exactly d), sums each generation's arrivals in its own sketch
  space, desketches each group with its own operator (re-derived from
  ``fold_in(base_key, g)``, which is why the driver's ``buffer=`` hook
  passes ``t`` and the base key) and applies

      update = sum_g desk_g( sum_{c arriving} w(d) sk_g^c / W ),
      w(d) = (1 + d)^(-staleness_alpha),   W = total arrival weight.

A round with no arrival applies a zero update (the server's moments still
decay), unless a sentinel carries the server through.  With
``delay="zero"`` every payload arrives in its own round at weight 1 and
the round is bit for bit ``safl_round``'s.
"""

from __future__ import annotations

import dataclasses
import functools
import operator

import torch

from repro_torch import prng
from repro_torch.core.adaptive import apply_update, init_opt_state
from repro_torch.core.clipped import ClippedSAFLConfig, clip_delta
from repro_torch.core.packed import (PackingPlan, derive_generation_params,
                                     derive_round_params, desk_flat,
                                     sk_packed_clients, unpack_tree)
from repro_torch.core.safl import (LossFn, _f32, client_deltas, masked_mean,
                                   resolve_microbatch)
from repro_torch.fed.codec import (encode_decode, init_codec_state,
                                   measured_uplink_bits)
from repro_torch.fed.participation import is_weighted_mask
from repro_torch.fed.robust import divergence_flag, guard_uplink, tree_where

_DELAY_STREAM_TAG = 7919   # decorrelates the delay stream from the data
                           # sampler's fold_in(key(seed), t, c) chain


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    """``max_delay`` is the largest client delay in rounds; the ring holds
    D = max_delay + 1 generations.  ``delay`` picks the policy: ``"zero"``
    (every client arrives at once, the synchronous round), ``"stagger"``
    (client c of generation g waits ``(c + g) % D`` rounds) or ``"uniform"``
    (iid uniform over ``[0, max_delay]`` from the per-(generation, client)
    stream)."""
    max_delay: int = 2
    delay: str = "uniform"          # zero | stagger | uniform
    staleness_alpha: float = 0.5    # w(d) = (1 + d)^-alpha
    seed: int = 0

    def __post_init__(self):
        if self.max_delay < 0:
            raise ValueError(f"max_delay must be >= 0, got {self.max_delay}")
        if self.delay not in ("zero", "stagger", "uniform"):
            raise ValueError(f"unknown delay policy {self.delay!r}")
        if self.staleness_alpha < 0.0:
            raise ValueError("staleness_alpha must be >= 0")

    @property
    def buffer_rounds(self) -> int:
        return self.max_delay + 1

    def delays(self, g: int, num_clients: int, device="cuda") -> torch.Tensor:
        """(G,) int32 delays of generation ``g``'s clients, pure in
        (g, client, seed): recomputed alike at push and at pop."""
        D = self.buffer_rounds
        if self.delay == "zero" or D == 1:
            return torch.zeros(num_clients, dtype=torch.int32, device=device)
        if self.delay == "stagger":
            return ((torch.arange(num_clients, device=device) + g) % D).to(torch.int32)
        key_g = prng.fold_in(prng.fold_in(prng.key(self.seed),
                                          _DELAY_STREAM_TAG), g)
        d = [prng.randint(prng.fold_in(key_g, c), (), 0, D, "cpu")
             for c in range(num_clients)]
        return torch.stack(d).to(device=device, dtype=torch.int32)


def arrival_weight(acfg: AsyncConfig, g: int, d: int, num_clients: int,
                   device="cuda") -> torch.Tensor:
    """(G,) staleness-discounted weights of generation ``g`` popped at delay
    ``d``: ``1{delay(g, c) == d} * (1 + d)^-alpha``, generations before the
    run (g < 0) masked out for d > 0 (d = 0 pops the round just pushed, so
    g = t >= 0).  The discount is a Python double, rounded to float32
    before the multiply as the reference's weakly typed scalar is."""
    arrive = acfg.delays(g, num_clients, device) == d
    if d > 0 and g < 0:
        arrive = torch.zeros_like(arrive)
    return arrive.to(torch.float32) * _f32((1.0 + d) ** -acfg.staleness_alpha)


def _split_cfg(cfg):
    if isinstance(cfg, ClippedSAFLConfig):
        return cfg.base, cfg
    return cfg, None


def init_async_state(cfg, acfg: AsyncConfig, params, plan: PackingPlan,
                     num_clients: int, codec=None) -> dict:
    """The server state and the staleness ring, on the params' device:
    ``buf[g % D]`` holds generation g's ``(G, b_total)`` payload rows and
    ``bufw`` their cohort weights (0 for unsampled clients).  ``cfg`` is a
    ``SAFLConfig`` or a ``ClippedSAFLConfig``; a ``codec`` with error
    feedback adds the per-client EF memory under ``"ef"``."""
    base, _ = _split_cfg(cfg)
    device = next(iter(params.values())).device
    D = acfg.buffer_rounds
    state = {"opt": init_opt_state(base.server, params),
             "buf": torch.zeros((D, num_clients, plan.b_total),
                                dtype=torch.float32, device=device),
             "bufw": torch.zeros((D, num_clients), dtype=torch.float32,
                                 device=device)}
    ef = init_codec_state(codec, num_clients, plan.b_total, device)
    if ef is not None:
        state["ef"] = ef
    return state


def make_async_round(cfg, loss_fn: LossFn, acfg: AsyncConfig,
                     plan: PackingPlan, microbatch=None, codec=None):
    """The async round for the driver's ``buffer=True`` hook:

        round_fn(params, state, batch, round_key, *, t, base_key,
                 part_mask=None, lr_scale=1.0, fault_spec=None,
                 sentinel=None, microbatch=microbatch)

    ``cfg`` is a ``SAFLConfig``, or a ``ClippedSAFLConfig`` for SACFL's
    clipped deltas.  ``microbatch`` below G stages the payload chunk by
    chunk (each chunk's rows land at their global offsets; the ring itself
    is O(D G b_total)).  ``codec`` quantizes the staged payload before the
    guard and the push, so the ring stores what crossed the wire; with
    error feedback, unsampled clients freeze their EF memory while dropped
    or rejected ones update theirs (the loss happened after encoding).
    Faults and sentinels vet the payload before the push, so the ring never
    stores a poisoned row.  Weighted masks raise ``TypeError``: the ring
    stores 0/1 cohorts."""
    base, clip = _split_cfg(cfg)
    D = acfg.buffer_rounds

    def round_fn(params, state, batch, round_key, *, t, base_key,
                 part_mask=None, lr_scale=1.0, fault_spec=None,
                 sentinel=None, microbatch=microbatch):
        if is_weighted_mask(part_mask):
            raise TypeError(
                "the async staleness buffer stores 0/1 cohort masks per "
                "generation; weighted (importance-sampling) masks are not "
                "supported: use a 0/1 participation policy")
        device = next(iter(params.values())).device
        eta = _f32(base.client_lr)
        clip_fn = None if clip is None else (lambda d: clip_delta(clip, d))
        G = next(iter(batch.values())).shape[0]
        mbv = resolve_microbatch(microbatch, G) or G
        mask = (torch.ones(G, dtype=torch.float32, device=device)
                if part_mask is None else part_mask)

        # push: generation t's payload takes slot t % D, whose tenant
        # (generation t - D) was fully drained by round t - 1
        rp_t = derive_round_params(plan, round_key, device)
        sks = torch.empty((G, plan.b_total), dtype=torch.float32, device=device)
        losses = torch.empty(G, dtype=torch.float32, device=device)
        for c0 in range(0, G, mbv):
            c1 = min(c0 + mbv, G)
            deltas, losses[c0:c1] = client_deltas(
                base, loss_fn, params, {k: v[c0:c1] for k, v in batch.items()},
                eta, clip=clip_fn)
            sks[c0:c1] = sk_packed_clients(plan, rp_t, deltas)
            del deltas
        new_ef = None
        if codec is not None:
            ef = state.get("ef")
            sks, ef_upd = encode_decode(codec, round_key, sks, ef_rows=ef)
            if ef is not None:
                new_ef = torch.where((mask > 0)[:, None], ef_upd, ef)
        counters = {}
        if fault_spec is not None or sentinel is not None:
            sks, mask, counters = guard_uplink(sks, mask, fault_spec, sentinel)
        slot_t = t % D
        buf, bufw = state["buf"].clone(), state["bufw"].clone()
        buf[slot_t] = sks
        bufw[slot_t] = mask

        # pop: client c of generation g = t - d arrives now iff its delay is
        # exactly d; each generation's group is summed in its own sketch
        # space and desketched with its own operator.  d = 0 reads the
        # payload just pushed
        weighted = []
        for d in range(D):
            if acfg.delay == "zero" and d > 0:
                continue                  # no arrival at d > 0
            g = t - d
            payload, w_in = (sks, mask) if d == 0 else (buf[g % D], bufw[g % D])
            w = w_in * arrival_weight(acfg, g, d, G, device)
            rp_g = rp_t if d == 0 else derive_generation_params(
                plan, base_key, g, device)
            weighted.append((torch.sum(w), torch.sum(w[:, None] * payload, dim=0),
                             rp_g))
        W = functools.reduce(operator.add, (wd for wd, _, _ in weighted))
        W_safe = torch.where(W > 0, W, 1.0)   # no arrival: a zero update
        update = unpack_tree(plan, functools.reduce(
            operator.add, (desk_flat(plan, rp_g, S_d / W_safe)
                           for _, S_d, rp_g in weighted)))
        new_params, opt = apply_update(base.server, state["opt"], params,
                                       update, lr_scale=lr_scale)
        loss = masked_mean(losses, part_mask)
        if sentinel is not None:
            # a round with no arrival carries the server through unchanged
            new_params, opt = tree_where(W > 0, (new_params, opt),
                                         (params, state["opt"]))
            counters["diverged"] = divergence_flag(sentinel, loss)
        metrics = {"loss": loss, "arrival_weight": W, **counters}
        if codec is not None:
            metrics["uplink_bits"] = measured_uplink_bits(codec, plan.b_total,
                                                          eff_mask=mask)
        new_state = {"opt": opt, "buf": buf, "bufw": bufw}
        if new_ef is not None:
            # outside the no-arrival select: EF tracks what each client
            # transmitted, and a round with no arrival still transmitted
            new_state["ef"] = new_ef
        return new_params, new_state, metrics

    return round_fn
