"""The multi-round driver: R federated rounds, metrics fetched per chunk.

Counterpart of ``repro/launch/driver.py`` with the participation hook.
``run_scan`` runs rounds in chunks of ``chunk_size``: each round draws its
batch on the device (``sampler.sample(state, t)``) and steps the round
function under the round key ``fold_in(key, t)``; the chunk's metrics stay
on the device and come to the host once per chunk, where
``on_chunk(t_done, params, state, chunk_hist)`` sees them.
``run_host_loop`` is the one-round-at-a-time reference with the same keys
and batches, fetching every round's metrics as it goes; the two give
bit-identical trajectories.

Hooks, each a pure function of the absolute round index t:
``kwargs_fn(t)`` adds keyword arguments to the round (e.g. ``{"lr_scale":
cosine(R)(t)}``), and ``participation`` (a ``fed.participation`` policy)
passes ``part_mask=policy.mask(t)``.  So a run resumed at ``start_round``
replays the uninterrupted trajectory bit for bit.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import prng

# (params, state, batch, round_key, **kwargs) -> (params, state, metrics)
RoundFn = Callable[..., tuple[Any, dict, dict]]

# every key a history dict may carry; the reference's counters and
# telemetry probes come with the hooks that produce them
HISTORY_KEYS = ("loss", "uplink_bits")


def _with_bits(metrics: dict, bits_per_round: Optional[int],
               mask=None) -> dict:
    """Stack the per-round uplink payload next to the loss (float32: the
    bits of a 100M-parameter model overflow int32).  With a participation
    mask, ``bits_per_round`` is per client and the round bills the sampled
    cohort: times ``mask["n"]`` for a weighted mask, else times the mask's
    sum."""
    if bits_per_round is None or "uplink_bits" in metrics:
        return metrics
    device = metrics["loss"].device
    bits = torch.tensor(float(bits_per_round), dtype=torch.float32,
                        device=device)
    if mask is not None:
        bits = bits * (mask["n"] if isinstance(mask, dict) else torch.sum(mask))
    return {**metrics, "uplink_bits": bits}


def round_hook_kwargs(t: int, kwargs_fn, participation, device):
    """The round's extra keyword arguments and its cohort mask: ``kwargs_fn(t)``
    and, with a policy, ``part_mask=participation.mask(t)`` on ``device``."""
    kw = dict(kwargs_fn(t)) if kwargs_fn is not None else {}
    mask = None
    if participation is not None:
        mask = participation.mask(t, device)
        kw["part_mask"] = mask
    return kw, mask


def _device_of(params) -> torch.device:
    return next(iter(params.values())).device


def _step(round_fn, sampler, params, state, data_state, key, t,
          bits_per_round, kwargs_fn, participation):
    data_state, batch = sampler.sample(data_state, t)
    kw, mask = round_hook_kwargs(t, kwargs_fn, participation,
                                 _device_of(params))
    params, state, m = round_fn(params, state, batch, prng.fold_in(key, t),
                                **kw)
    return params, state, data_state, _with_bits(m, bits_per_round, mask)


def _to_host(hist: list[dict]) -> dict[str, np.ndarray]:
    return {k: torch.stack([h[k] for h in hist]).cpu().numpy() for k in hist[0]}


def run_scan(round_fn: RoundFn, sampler, params, state: dict, *,
             rounds: int, key: prng.Key, chunk_size: int = 0,
             kwargs_fn=None, bits_per_round: Optional[int] = None,
             on_chunk=None, participation=None, start_round: int = 0):
    """Run rounds ``start_round .. rounds - 1`` in chunks of ``chunk_size``
    (0 = all in one); returns ``(params, state, history)`` with history a
    dict of ``(rounds - start_round,)`` host arrays (``loss``, and
    ``uplink_bits`` when ``bits_per_round`` is given: per round, or per
    client under ``participation``).  ``kwargs_fn`` and ``participation``
    are the hooks of the module docstring; ``start_round`` resumes a run
    at an absolute round index (from a checkpointed cursor)."""
    chunk_size = int(chunk_size) or int(rounds)
    data_state = sampler.init_state(_device_of(params))
    hists = []
    t = int(start_round)
    while t < rounds:
        n = min(chunk_size, rounds - t)
        chunk = []
        for tt in range(t, t + n):
            params, state, data_state, m = _step(
                round_fn, sampler, params, state, data_state, key, tt,
                bits_per_round, kwargs_fn, participation)
            chunk.append(m)
        hist = _to_host(chunk)              # ONE fetch per chunk
        hists.append(hist)
        t += n
        if on_chunk is not None:
            on_chunk(t, params, state, hist)
    if not hists:                           # resumed at start_round == rounds
        return params, state, {}
    return params, state, {k: np.concatenate([h[k] for h in hists])
                           for k in hists[0]}


def run_host_loop(round_fn: RoundFn, sampler, params, state: dict, *,
                  rounds: int, key: prng.Key, kwargs_fn=None,
                  bits_per_round: Optional[int] = None, participation=None,
                  start_round: int = 0):
    """One round at a time with the scan driver's exact key/batch sequence
    and hooks, fetching each round's metrics before the next round starts."""
    data_state = sampler.init_state(_device_of(params))
    hists = []
    for t in range(int(start_round), rounds):
        params, state, data_state, m = _step(
            round_fn, sampler, params, state, data_state, key, t,
            bits_per_round, kwargs_fn, participation)
        hists.append({k: v.cpu().numpy() for k, v in m.items()})
    if not hists:
        return params, state, {}
    return params, state, {k: np.stack([h[k] for h in hists]) for k in hists[0]}
