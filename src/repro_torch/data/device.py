"""Device-resident federated batch sampling for the round driver.

Counterpart of ``repro/data/device.py::DeviceBigramSampler``,
``DeviceGaussianClsSampler`` and ``ShardedSampler``.  The tokens
of client ``c`` in round ``t`` are a pure function of ``(t, c, seed)``:
the key is ``fold_in(fold_in(key(seed), t), c)``, split into a key for the
first token and one per later position, exactly as the reference draws
them, so the port's batches are bit-identical to the reference's
``round_batch(t)``.  Token ``s`` is drawn from the cumulative transition
row of token ``s - 1`` by counting the entries a uniform variate exceeds.

All clients and positions draw their uniforms in one pass over the
device; the walk along the sequence is a loop over positions, vectorized
over clients and sequences.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import prng


@dataclasses.dataclass(frozen=True)
class DeviceBigramSampler:
    """Bigram LM batch sampler: ``init_state(device)`` puts the cumulative
    transition rows on the device, ``sample(state, t)`` draws round ``t``'s
    batch shaped ``(G, K, mb, seq)``."""
    trans_cum: np.ndarray          # (G, V, V) per-client cumulative rows
    batch_per_client: int
    local_steps: int
    seq_len: int
    vocab_size: int
    num_clients: int
    seed: int

    @classmethod
    def from_data(cls, data, batch_per_client: int,
                  local_steps: int) -> "DeviceBigramSampler":
        """Build from a ``BigramLMData`` (same transition matrices)."""
        cfg = data.cfg
        cum = np.cumsum(np.stack(data.trans), axis=2).astype(np.float32)
        return cls(trans_cum=cum, batch_per_client=batch_per_client,
                   local_steps=local_steps, seq_len=cfg.seq_len,
                   vocab_size=cfg.vocab_size, num_clients=cfg.num_clients,
                   seed=cfg.seed)

    def init_state(self, device="cuda") -> dict:
        return {"trans_cum": torch.as_tensor(self.trans_cum, device=device)}

    def sample(self, state: dict, t: int, start: int = 0,
               stop: int | None = None) -> tuple[dict, dict]:
        """Draw round ``t``'s batch: ``{"tokens": (G, K, mb, seq) int64}``,
        or only the rows of clients ``[start, stop)``, bit for bit the
        whole batch's rows."""
        cum = state["trans_cum"]
        device = cum.device
        stop = self.num_clients if stop is None else stop
        G, B, S = stop - start, self.batch_per_client, self.seq_len
        V = self.vocab_size
        round_key = prng.fold_in(prng.key(self.seed), t)
        firsts, step_keys = [], []
        for c in range(start, stop):
            k_first, k_seq = prng.split(prng.fold_in(round_key, c))
            firsts.append(prng.randint(k_first, (B,), 0, V, device))
            step_keys.extend(prng.split(k_seq, S - 1))
        u = prng.uniform_many(step_keys, (B,), device).reshape(G, S - 1, B)
        prev = torch.stack(firsts)                                 # (G, B)
        toks = [prev]
        rows = torch.arange(start, stop, device=device)[:, None]
        for s in range(S - 1):
            nxt = torch.sum(cum[rows, prev] < u[:, s, :, None], dim=-1)
            # a float cumsum can top out slightly below 1.0; clamp the
            # (measure-zero) overflow instead of emitting token V
            prev = torch.clamp(nxt, max=V - 1)
            toks.append(prev)
        tokens = torch.stack(toks, dim=-1)                         # (G, B, S)
        mb = B // self.local_steps
        return state, {"tokens": tokens.reshape(G, self.local_steps, mb, S)}

    def round_batch(self, t: int, device="cuda") -> dict:
        """One round's batch outside the driver (tests)."""
        return self.sample(self.init_state(device), t)[1]


@dataclasses.dataclass(frozen=True)
class DeviceGaussianClsSampler:
    """Gaussian-mixture classification sampler, with the protocol and the
    determinism of ``DeviceBigramSampler``: client ``c``'s batch in round
    ``t`` comes from ``fold_in(fold_in(key(seed), t), c)``, split into a
    label key and a feature key.  Labels are drawn by inverse CDF on the
    client's cumulative label row (bit for bit the reference's), features
    are the class center plus ``prng.normal`` noise (its uniforms bit for
    bit, ``erfinv`` within ~1e-5 relative).  All clients draw in one pass
    over the device."""
    centers: np.ndarray            # (C, F) class centers
    label_cum: np.ndarray          # (G, C) per-client cumulative label probs
    batch_per_client: int
    local_steps: int
    num_features: int
    num_classes: int
    num_clients: int
    seed: int

    @classmethod
    def from_data(cls, data, batch_per_client: int,
                  local_steps: int) -> "DeviceGaussianClsSampler":
        """Build from a ``GaussianClsData`` (same centers and label skew)."""
        cfg = data.cfg
        cum = np.cumsum(np.asarray(data.label_probs, np.float32), axis=1)
        return cls(centers=np.asarray(data.centers, np.float32),
                   label_cum=cum.astype(np.float32),
                   batch_per_client=batch_per_client, local_steps=local_steps,
                   num_features=cfg.num_features, num_classes=cfg.num_classes,
                   num_clients=cfg.num_clients, seed=cfg.seed)

    def init_state(self, device="cuda") -> dict:
        return {"centers": torch.as_tensor(self.centers, device=device),
                "label_cum": torch.as_tensor(self.label_cum, device=device)}

    def _draw(self, centers, label_cum, keys):
        """(n, B, F) features and (n, B) labels of the clients whose
        (label, feature) keys are ``keys`` and cumulative rows ``label_cum``."""
        device = centers.device
        B, F, C = self.batch_per_client, self.num_features, self.num_classes
        u = prng.uniform_many([k[0] for k in keys], (B,), device)
        y = torch.clamp(torch.sum(label_cum[:, None, :] < u[:, :, None], dim=-1),
                        max=C - 1)
        x = centers[y] + prng.normal_many([k[1] for k in keys], (B, F), device)
        return x, y

    def _keys(self, t: int, start: int = 0, stop: int | None = None) -> list:
        round_key = prng.fold_in(prng.key(self.seed), t)
        stop = self.num_clients if stop is None else stop
        return [prng.split(prng.fold_in(round_key, c))
                for c in range(start, stop)]

    def _shape(self, x, y) -> dict:
        G, K = y.shape[0], self.local_steps
        mb = self.batch_per_client // K
        return {"x": x.reshape(G, K, mb, self.num_features),
                "y": y.reshape(G, K, mb)}

    def sample(self, state: dict, t: int, start: int = 0,
               stop: int | None = None) -> tuple[dict, dict]:
        """Draw round ``t``'s batch: x (G, K, mb, F) float32, y (G, K, mb)
        int64; or only the rows of clients ``[start, stop)``, bit for bit
        the whole batch's rows."""
        x, y = self._draw(state["centers"], state["label_cum"][start:stop],
                          self._keys(t, start, stop))
        return state, self._shape(x, y)

    def round_batch(self, t: int, device="cuda") -> dict:
        """One round's batch outside the driver (tests)."""
        return self.sample(self.init_state(device), t)[1]

    def host_round_batch(self, t: int) -> dict:
        """The same batch drawn client by client on the host (numpy out),
        bit for bit ``sample``'s on the CPU."""
        state = self.init_state("cpu")
        draws = [self._draw(state["centers"], state["label_cum"][c:c + 1], [k])
                 for c, k in enumerate(self._keys(t))]
        x, y = (torch.cat(v) for v in zip(*draws))
        return {k: v.numpy() for k, v in self._shape(x, y).items()}


@dataclasses.dataclass(frozen=True)
class ShardedSampler:
    """One mesh rank's view of a sampler with the ``init_state(device)/
    sample(state, t)`` protocol: the rows ``[start, stop)`` of the client
    axis of each batch, the clients this rank trains.

    A client's rows depend only on ``(t, c, seed)``, so the base sampler
    draws the rank's clients alone (``sample(state, t, start, stop)``), bit
    for bit the rows of the whole batch, and the mesh trajectory stays
    comparable to the single-host driver's.  Build
    via ``launch.train.mesh_sampler``, which derives the rows from the
    rank's client index (its row-major index over the client axes, the
    order in which the reference's ``shard_map`` splits the client axis);
    this class stays mesh-agnostic."""
    base: Any
    start: int
    stop: int

    @property
    def num_clients(self) -> int:
        """The clients of the whole batch, every rank's rows together."""
        return self.base.num_clients

    def init_state(self, device="cuda") -> dict:
        return self.base.init_state(device)

    def sample(self, state: dict, t: int) -> tuple[dict, dict]:
        return self.base.sample(state, t, self.start, self.stop)
