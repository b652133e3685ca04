"""Clipped SAFL (SACFL) for heavy-tailed client noise, in PyTorch.

Counterpart of ``repro/core/clipped.py``.  Each client clips its local
model delta to an l2 ball of radius ``tau`` BEFORE sketching.  Clipping
acts on the true delta, so the sketch's linearity (over the averaged
clipped deltas) and unbiasedness are untouched and the server's ADA_OPT
step is unchanged; with tau -> inf the round is SAFL's.

The global norm sums the leaves' float32 squared sums in ``leaf_names``
order (the reference sums its leaves in jax's flatten order, and each
reduction in XLA's order, so the two packages agree to float32 rounding).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import prng
from repro_torch.core.packed import PackingPlan
from repro_torch.core.safl import (_CODEC_TELEMETRY, _STREAMED_TELEMETRY,
                                   LossFn, SAFLConfig, Tree, _f32,
                                   _num_clients, client_deltas,
                                   resolve_microbatch, sketched_round,
                                   streamed_sketch_round)
from repro_torch.core.sketch import leaf_names


@dataclasses.dataclass(frozen=True)
class ClippedSAFLConfig:
    base: SAFLConfig = SAFLConfig()
    clip_tau: float = 1.0          # l2 radius for the client delta
    per_tensor: bool = False       # clip each tensor separately vs globally


def _norm(xs) -> torch.Tensor:
    """sqrt(sum of float32 squares + 1e-12) over the tensors ``xs``."""
    sq = sum(torch.sum(x.to(torch.float32) ** 2) for x in xs)
    return torch.sqrt(sq + 1e-12)


def _tau(cfg: ClippedSAFLConfig, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(cfg.clip_tau, dtype=torch.float32, device=like.device)


def clip_delta(cfg: ClippedSAFLConfig, delta: Tree) -> dict[str, torch.Tensor]:
    """l2-clip one client's delta (global norm by default)."""
    if cfg.per_tensor:
        return {k: x * torch.clamp(_tau(cfg, x) / _norm([x]), max=1.0)
                for k, x in delta.items()}
    nrm = _norm([delta[k] for k in leaf_names(delta)])
    scale = torch.clamp(_tau(cfg, nrm) / nrm, max=1.0)
    return {k: x * scale for k, x in delta.items()}


def clip_trigger(cfg: ClippedSAFLConfig, delta: Tree) -> torch.Tensor:
    """1.0 if this client's pre-clip delta exceeded the clip radius (under
    per-tensor clipping: if ANY tensor did), else 0.0 (float32)."""
    if cfg.per_tensor:
        trig = torch.stack([_norm([x]) > cfg.clip_tau for x in delta.values()])
        return torch.any(trig).to(torch.float32)
    nrm = _norm([delta[k] for k in leaf_names(delta)])
    return (nrm > cfg.clip_tau).to(torch.float32)


def clipped_safl_round(cfg: ClippedSAFLConfig, loss_fn: LossFn, params: Tree,
                       opt_state: dict, batch, round_key: prng.Key, *,
                       plan: Optional[PackingPlan] = None, part_mask=None,
                       fault_spec=None, sentinel=None, telemetry=None,
                       microbatch=None, codec=None) -> tuple[dict, dict, dict]:
    """One SAFL round with per-client delta clipping (heavy-tail defense).
    ``batch`` leaves are (G, K, mb, ...) as in ``safl_round``; ``plan``,
    ``part_mask``, ``fault_spec``, ``sentinel``, ``telemetry``,
    ``microbatch`` and ``codec`` as there: clipping acts on each client's
    true delta before the sketch, so it composes with the streamed fold,
    the codec and the guard as sketching does.  With ``telemetry.clip``
    the round adds the ``clip_frac`` probe: the effective cohort's share
    whose pre-clip delta norm exceeded tau.  The client lr and the server
    lr are the config's (no schedule scales, as in the reference)."""
    if codec is not None and telemetry is not None:
        raise ValueError(_CODEC_TELEMETRY)
    base = cfg.base
    eta = _f32(base.client_lr)
    triggers = [] if telemetry is not None and telemetry.clip else None

    def clip(d):
        if triggers is not None:
            triggers.append(clip_trigger(cfg, d))
        return clip_delta(cfg, d)

    client_fn = lambda b: client_deltas(base, loss_fn, params, b, eta, clip=clip)
    hooks = dict(plan=plan, part_mask=part_mask, fault_spec=fault_spec,
                 sentinel=sentinel, codec=codec)
    mb = resolve_microbatch(microbatch, _num_clients(batch))
    if mb is not None:
        if telemetry is not None:
            raise ValueError(_STREAMED_TELEMETRY)
        return streamed_sketch_round(base, client_fn, params, opt_state, batch,
                                     round_key, mb, **hooks)
    return sketched_round(base, client_fn, params, opt_state, batch, round_key,
                          telemetry=telemetry, triggers=triggers, **hooks)
