"""Synthetic federated LM data: bigram Markov chains per client.

Counterpart of ``repro/data/synthetic.py`` (``LMDataConfig``,
``BigramLMData``).  The transition tables are pure numpy, drawn exactly as
the reference draws them, so both packages sample from identical chains.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    vocab_size: int = 256
    seq_len: int = 64
    num_clients: int = 5
    heterogeneity: float = 0.0   # 0 = iid; >0 = per-client transition skew
    alpha: float = 0.3           # Dirichlet concentration; lower => more
                                 # predictable chains (lower entropy floor)
    seed: int = 0


class BigramLMData:
    """Markov-chain token generator; each client can get a skewed chain."""

    def __init__(self, cfg: LMDataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        base = rng.dirichlet(np.ones(cfg.vocab_size) * cfg.alpha,
                             size=cfg.vocab_size)
        self.trans = []
        for c in range(cfg.num_clients):
            if cfg.heterogeneity > 0:
                skew = rng.dirichlet(np.ones(cfg.vocab_size) * cfg.alpha,
                                     size=cfg.vocab_size)
                t = (1 - cfg.heterogeneity) * base + cfg.heterogeneity * skew
            else:
                t = base
            self.trans.append(t / t.sum(axis=1, keepdims=True))

    def device_sampler(self, batch_per_client: int, local_steps: int):
        """The device-side sampler over the same transition matrices."""
        from repro_torch.data.device import DeviceBigramSampler
        return DeviceBigramSampler.from_data(self, batch_per_client,
                                             local_steps)
