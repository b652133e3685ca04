"""The multi-round driver: R federated rounds, metrics fetched per chunk.

Counterpart of ``repro/launch/driver.py`` with the federated hooks.
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
cosine(R)(t)}``), ``participation`` (a ``fed.participation`` policy)
passes ``part_mask=policy.mask(t)``, ``faults`` (``fed.faults``) passes
``fault_spec=faults.spec(t, key)``, and ``buffer=True`` passes ``t=`` and
``base_key=`` to an async round (``fed.async_buffer``), which re-derives
older generations' operators from them.  So a run resumed at
``start_round`` replays the uninterrupted trajectory bit for bit.
``microbatch`` and ``codec`` are bound into the round as keywords; the
sentinel, the telemetry config and the plan are bound by the caller
(``functools.partial``).  ``stream`` (an ``obs.shards.ShardWriter``)
writes each chunk's metrics to a JSONL shard and its wall time to the
event log; it adds host I/O and nothing else.
"""

from __future__ import annotations

import functools
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.obs.telemetry import PROBE_KEYS

# (params, state, batch, round_key, **kwargs) -> (params, state, metrics)
RoundFn = Callable[..., tuple[Any, dict, dict]]

# counters the guarded and buffered rounds emit beside the loss: the
# guard's n_dropped/n_rejected, the sentinel's diverged flag and the async
# buffer's arrival_weight
COUNTER_KEYS = ("n_dropped", "n_rejected", "diverged", "arrival_weight")

# every key a history dict or metric shard row may carry: which appear
# depends on the hooks bound into the round (the counters) and on its
# ``obs.Telemetry`` config (the probes); tools/check_telemetry.py reads the
# reference's equal tuple
HISTORY_KEYS = ("loss", "uplink_bits") + COUNTER_KEYS + PROBE_KEYS


def _with_bits(metrics: dict, bits_per_round: Optional[int], mask=None,
               num_clients: Optional[int] = None) -> dict:
    """Stack the per-round uplink payload next to the loss (float32: the
    bits of a 100M-parameter model overflow int32).  With a participation
    mask, ``bits_per_round`` is per client and the round bills the
    effective cohort: ``mask["n"]`` for a weighted mask, else the mask's
    sum, less the round's ``n_dropped`` and ``n_rejected`` (a dropped
    payload never arrives, a rejected one is discarded).  Without a mask,
    ``bits_per_round`` is the whole cohort's and, when the guard counters
    are present, it is scaled by the surviving fraction ``(num_clients -
    lost) / num_clients`` (``num_clients`` from the fault policy).  A
    round that reports its own measured ``uplink_bits`` (the codec) keeps
    it."""
    if bits_per_round is None or "uplink_bits" in metrics:
        return metrics
    device = metrics["loss"].device
    bits = torch.tensor(float(bits_per_round), dtype=torch.float32,
                        device=device)
    lost = None
    if "n_dropped" in metrics or "n_rejected" in metrics:
        lost = sum(metrics[k] for k in ("n_dropped", "n_rejected")
                   if k in metrics)
    if mask is not None:
        n = mask["n"] if isinstance(mask, dict) else torch.sum(mask)
        if lost is not None:
            n = n - lost
        bits = bits * n
    elif lost is not None and num_clients is not None:
        bits = bits * (num_clients - lost) / num_clients
    return {**metrics, "uplink_bits": bits}


def round_hook_kwargs(t: int, key: prng.Key, kwargs_fn, participation,
                      buffer: bool, faults, device):
    """The round's extra keyword arguments and its cohort mask: ``kwargs_fn(t)``;
    with a policy ``part_mask=participation.mask(t)``; with ``buffer``, the
    round index ``t`` and the run's ``base_key``; with a fault policy
    ``fault_spec=faults.spec(t, key)``, drawn against the run key.  Every
    tensor on ``device``."""
    kw = dict(kwargs_fn(t)) if kwargs_fn is not None else {}
    mask = None
    if participation is not None:
        mask = participation.mask(t, device)
        kw["part_mask"] = mask
    if buffer:
        kw["t"] = t
        kw["base_key"] = key
    if faults is not None:
        kw["fault_spec"] = faults.spec(t, key, device)
    return kw, mask


def _device_of(params) -> torch.device:
    return next(iter(params.values())).device


def _bind(round_fn, microbatch, codec):
    """Bind the static ``microbatch`` and ``codec`` keywords into the round."""
    if microbatch is not None:
        round_fn = functools.partial(round_fn, microbatch=microbatch)
    if codec is not None:
        round_fn = functools.partial(round_fn, codec=codec)
    return round_fn


def _step(round_fn, sampler, params, state, data_state, key, t,
          bits_per_round, kwargs_fn, participation, buffer, faults):
    data_state, batch = sampler.sample(data_state, t)
    kw, mask = round_hook_kwargs(t, key, kwargs_fn, participation, buffer,
                                 faults, _device_of(params))
    params, state, m = round_fn(params, state, batch, prng.fold_in(key, t),
                                **kw)
    return params, state, data_state, _with_bits(
        m, bits_per_round, mask, getattr(faults, "num_clients", None))


def _to_host(hist: list[dict]) -> dict[str, np.ndarray]:
    return {k: torch.stack([h[k] for h in hist]).cpu().numpy() for k in hist[0]}


def run_scan(round_fn: RoundFn, sampler, params, state: dict, *,
             rounds: int, key: prng.Key, chunk_size: int = 0,
             kwargs_fn=None, bits_per_round: Optional[int] = None,
             on_chunk=None, participation=None, buffer: bool = False,
             faults=None, microbatch=None, codec=None, start_round: int = 0,
             stream=None):
    """Run rounds ``start_round .. rounds - 1`` in chunks of ``chunk_size``
    (0 = all in one); returns ``(params, state, history)`` with history a
    dict of ``(rounds - start_round,)`` host arrays (``loss``, and
    ``uplink_bits`` when ``bits_per_round`` is given: per round, or per
    client under ``participation``), the ``COUNTER_KEYS`` the bound round
    emits and the ``PROBE_KEYS`` its telemetry config selects.
    ``kwargs_fn``, ``participation``, ``buffer`` and ``faults`` are the
    hooks of the module docstring; ``microbatch`` (the streamed fold's
    chunk) and ``codec`` (``fed.codec.CodecConfig``; with error feedback
    ``state`` is the wrapped ``{"opt", "ef"}`` dict) are bound into the
    round; ``start_round`` resumes a run at an absolute round index (from
    a checkpointed cursor).

    ``stream`` (an ``obs.shards.ShardWriter``) takes each chunk's history,
    fetched to the host in one ``host_fetch``, as one metrics shard, and
    the chunk's wall time as a span event; ``compile=True`` marks the
    first chunk of each length, as in the reference (the port compiles
    nothing per length: that chunk carries the kernels' first build and
    launch when the process has not run them yet).  The history then
    lives in the shards only and the returned ``history`` is ``{}``;
    ``on_chunk`` sees each chunk's host history either way.  Parameters,
    state and metrics are those of the unstreamed run, bit for bit."""
    round_fn = _bind(round_fn, microbatch, codec)
    chunk_size = int(chunk_size) or int(rounds)
    data_state = sampler.init_state(_device_of(params))
    seen: set[int] = set()
    hists = []
    t = int(start_round)
    while t < rounds:
        n = min(chunk_size, rounds - t)
        fresh = n not in seen
        seen.add(n)
        t_wall = time.perf_counter()
        chunk = []
        for tt in range(t, t + n):
            params, state, data_state, m = _step(
                round_fn, sampler, params, state, data_state, key, tt,
                bits_per_round, kwargs_fn, participation, buffer, faults)
            chunk.append(m)
        if stream is not None:
            from repro_torch.obs.shards import host_fetch
            hist = host_fetch({k: torch.stack([h[k] for h in chunk])
                               for k in chunk[0]})    # ONE fetch per chunk
            dt = time.perf_counter() - t_wall
            stream.write_chunk(t, hist)
            stream.write_span(t, t + n, dt, compile=fresh)
        else:
            hist = _to_host(chunk)          # ONE fetch per chunk
            hists.append(hist)
        t += n
        if on_chunk is not None:
            on_chunk(t, params, state, hist)
    if not hists:               # streamed, or resumed at start_round == rounds
        return params, state, {}
    return params, state, {k: np.concatenate([h[k] for h in hists])
                           for k in hists[0]}


def run_host_loop(round_fn: RoundFn, sampler, params, state: dict, *,
                  rounds: int, key: prng.Key, kwargs_fn=None,
                  bits_per_round: Optional[int] = None, participation=None,
                  buffer: bool = False, faults=None, microbatch=None,
                  codec=None, start_round: int = 0):
    """One round at a time with the scan driver's exact key/batch sequence
    and hooks, fetching each round's metrics before the next round starts."""
    round_fn = _bind(round_fn, microbatch, codec)
    data_state = sampler.init_state(_device_of(params))
    hists = []
    for t in range(int(start_round), rounds):
        params, state, data_state, m = _step(
            round_fn, sampler, params, state, data_state, key, t,
            bits_per_round, kwargs_fn, participation, buffer, faults)
        hists.append({k: v.cpu().numpy() for k, v in m.items()})
    if not hists:
        return params, state, {}
    return params, state, {k: np.stack([h[k] for h in hists]) for k in hists[0]}
