"""The multi-round driver: R federated rounds, metrics fetched per chunk.

Counterpart of ``repro/launch/driver.py`` without the federated hooks.
``run_scan`` runs rounds in chunks of ``chunk_size``: each round draws its
batch on the device (``sampler.sample(state, t)``) and steps the round
function under the round key ``fold_in(key, t)``; the chunk's metrics stay
on the device and come to the host once per chunk, where
``on_chunk(t_done, params, state, chunk_hist)`` sees them.
``run_host_loop`` is the one-round-at-a-time reference with the same keys
and batches, fetching every round's metrics as it goes; the two give
bit-identical trajectories.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import prng

# (params, state, batch, round_key) -> (params, state, metrics)
RoundFn = Callable[..., tuple[Any, dict, dict]]

# every key a history dict may carry; the reference's counters and
# telemetry probes come with the hooks that produce them
HISTORY_KEYS = ("loss", "uplink_bits")


def _with_bits(metrics: dict, bits_per_round: Optional[int]) -> dict:
    """Stack the per-round uplink payload next to the loss (float32: the
    bits of a 100M-parameter model overflow int32)."""
    if bits_per_round is None or "uplink_bits" in metrics:
        return metrics
    device = metrics["loss"].device
    return {**metrics, "uplink_bits": torch.tensor(
        float(bits_per_round), dtype=torch.float32, device=device)}


def _device_of(params) -> torch.device:
    return next(iter(params.values())).device


def _step(round_fn, sampler, params, state, data_state, key, t,
          bits_per_round):
    data_state, batch = sampler.sample(data_state, t)
    params, state, m = round_fn(params, state, batch, prng.fold_in(key, t))
    return params, state, data_state, _with_bits(m, bits_per_round)


def _to_host(hist: list[dict]) -> dict[str, np.ndarray]:
    return {k: torch.stack([h[k] for h in hist]).cpu().numpy() for k in hist[0]}


def run_scan(round_fn: RoundFn, sampler, params, state: dict, *,
             rounds: int, key: prng.Key, chunk_size: int = 0,
             bits_per_round: Optional[int] = None, on_chunk=None):
    """Run rounds ``0 .. rounds - 1`` in chunks of ``chunk_size`` (0 = all
    in one); returns ``(params, state, history)`` with history a dict of
    ``(rounds,)`` host arrays (``loss``, and ``uplink_bits`` when
    ``bits_per_round`` is given)."""
    chunk_size = int(chunk_size) or int(rounds)
    data_state = sampler.init_state(_device_of(params))
    hists = []
    t = 0
    while t < rounds:
        n = min(chunk_size, rounds - t)
        chunk = []
        for tt in range(t, t + n):
            params, state, data_state, m = _step(
                round_fn, sampler, params, state, data_state, key, tt,
                bits_per_round)
            chunk.append(m)
        hist = _to_host(chunk)              # ONE fetch per chunk
        hists.append(hist)
        t += n
        if on_chunk is not None:
            on_chunk(t, params, state, hist)
    if not hists:
        return params, state, {}
    return params, state, {k: np.concatenate([h[k] for h in hists])
                           for k in hists[0]}


def run_host_loop(round_fn: RoundFn, sampler, params, state: dict, *,
                  rounds: int, key: prng.Key,
                  bits_per_round: Optional[int] = None):
    """One round at a time with the scan driver's exact key/batch sequence,
    fetching each round's metrics before the next round starts."""
    data_state = sampler.init_state(_device_of(params))
    hists = []
    for t in range(rounds):
        params, state, data_state, m = _step(
            round_fn, sampler, params, state, data_state, key, t,
            bits_per_round)
        hists.append({k: v.cpu().numpy() for k, v in m.items()})
    return params, state, {k: np.stack([h[k] for h in hists]) for k in hists[0]}
