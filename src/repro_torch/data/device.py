"""Device-resident federated batch sampling for the round driver.

Counterpart of ``repro/data/device.py::DeviceBigramSampler``.  The tokens
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

    def sample(self, state: dict, t: int) -> tuple[dict, dict]:
        """Draw round ``t``'s batch: ``{"tokens": (G, K, mb, seq) int64}``."""
        cum = state["trans_cum"]
        device = cum.device
        G, B, S = self.num_clients, self.batch_per_client, self.seq_len
        V = self.vocab_size
        round_key = prng.fold_in(prng.key(self.seed), t)
        firsts, step_keys = [], []
        for c in range(G):
            k_first, k_seq = prng.split(prng.fold_in(round_key, c))
            firsts.append(prng.randint(k_first, (B,), 0, V, device))
            step_keys.extend(prng.split(k_seq, S - 1))
        u = prng.uniform_many(step_keys, (B,), device).reshape(G, S - 1, B)
        prev = torch.stack(firsts)                                 # (G, B)
        toks = [prev]
        rows = torch.arange(G, device=device)[:, None]
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
