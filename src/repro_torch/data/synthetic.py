"""Synthetic federated data: bigram Markov chains per client, and a
Gaussian-mixture classification task.

Counterpart of ``repro/data/synthetic.py`` (``LMDataConfig``,
``BigramLMData``, ``ClsDataConfig``, ``GaussianClsData``).  The transition
tables, class centers and label skews are pure numpy, drawn exactly as the
reference draws them, so both packages sample from identical
distributions; the batches come from the device samplers
(``data/device.py``).
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


@dataclasses.dataclass(frozen=True)
class ClsDataConfig:
    num_features: int = 32
    num_classes: int = 10
    num_clients: int = 5
    dirichlet_alpha: float = 0.0  # 0 = iid label distribution
    seed: int = 0


class GaussianClsData:
    """Gaussian-mixture classification with optional Dirichlet label skew:
    ``centers`` (C, F), and ``label_probs`` (G, C) per client."""

    def __init__(self, cfg: ClsDataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self.centers = rng.normal(size=(cfg.num_classes, cfg.num_features)) * 2.0
        if cfg.dirichlet_alpha > 0:
            self.label_probs = rng.dirichlet(
                np.ones(cfg.num_classes) * cfg.dirichlet_alpha,
                size=cfg.num_clients)
        else:
            self.label_probs = np.full(
                (cfg.num_clients, cfg.num_classes), 1.0 / cfg.num_classes)

    def device_sampler(self, batch_per_client: int, local_steps: int):
        """The device-side sampler over the same centers and label skew."""
        from repro_torch.data.device import DeviceGaussianClsSampler
        return DeviceGaussianClsSampler.from_data(self, batch_per_client,
                                                  local_steps)
