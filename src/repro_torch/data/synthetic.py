"""Synthetic federated data: bigram Markov chains per client, and a
Gaussian-mixture classification task.

Counterpart of ``repro/data/synthetic.py`` (``LMDataConfig``,
``BigramLMData``, ``ClsDataConfig``, ``GaussianClsData``).  The transition
tables, class centers and label skews are pure numpy, drawn exactly as the
reference draws them, so both packages sample from identical
distributions.  The batches come from the device samplers
(``data/device.py``), or from the host: ``client_batch`` and
``round_batch`` draw with numpy's ``default_rng`` exactly as the
reference's do, and hand the tensors to a device (tokens and labels as
int64, the port's index type).  ``synthetic_lm_batch`` draws uniform
random tokens through ``prng.randint``, jax's stream bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import prng


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

    def _client_tokens(self, client: int, batch_size: int, seed: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng((seed, client))
        cum = np.cumsum(self.trans[client], axis=1)
        toks = np.empty((batch_size, cfg.seq_len), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, batch_size)
        for s in range(1, cfg.seq_len):
            u = rng.random(batch_size)
            toks[:, s] = (cum[toks[:, s - 1]] < u[:, None]).sum(axis=1)
        return toks

    def client_batch(self, client: int, batch_size: int, seed: int,
                     device="cuda") -> dict:
        """Client ``client``'s ``(batch_size, seq)`` tokens of draw ``seed``."""
        toks = self._client_tokens(client, batch_size, seed)
        return {"tokens": torch.as_tensor(toks, dtype=torch.int64, device=device)}

    def round_batch(self, batch_per_client: int, local_steps: int, seed: int,
                    device="cuda") -> dict:
        """Batch for one round: ``{"tokens": (G, K, mb, seq)}``."""
        cfg = self.cfg
        toks = np.stack([self._client_tokens(c, batch_per_client, seed)
                         for c in range(cfg.num_clients)])
        toks = toks.reshape(cfg.num_clients, local_steps,
                            batch_per_client // local_steps, cfg.seq_len)
        return {"tokens": torch.as_tensor(toks, dtype=torch.int64, device=device)}

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

    def _client_arrays(self, client: int, batch_size: int,
                       seed: int) -> tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng((seed, client, 7))
        y = rng.choice(self.cfg.num_classes, size=batch_size,
                       p=self.label_probs[client])
        x = self.centers[y] + rng.normal(size=(batch_size,
                                               self.cfg.num_features))
        return x.astype(np.float32), y

    def client_batch(self, client: int, batch_size: int, seed: int,
                     device="cuda") -> dict:
        """Client ``client``'s features ``x`` (float32) and labels ``y``."""
        x, y = self._client_arrays(client, batch_size, seed)
        return {"x": torch.as_tensor(x, device=device),
                "y": torch.as_tensor(y, dtype=torch.int64, device=device)}

    def round_batch(self, batch_per_client: int, local_steps: int, seed: int,
                    device="cuda") -> dict:
        """Batch for one round: ``x`` (G, K, mb, F) and ``y`` (G, K, mb)."""
        per = [self._client_arrays(c, batch_per_client, seed)
               for c in range(self.cfg.num_clients)]
        shape = (self.cfg.num_clients, local_steps, batch_per_client // local_steps)
        x = np.stack([p[0] for p in per]).reshape(shape + (self.cfg.num_features,))
        y = np.stack([p[1] for p in per]).reshape(shape)
        return {"x": torch.as_tensor(x, device=device),
                "y": torch.as_tensor(y, dtype=torch.int64, device=device)}

    def device_sampler(self, batch_per_client: int, local_steps: int):
        """The device-side sampler over the same centers and label skew."""
        from repro_torch.data.device import DeviceGaussianClsSampler
        return DeviceGaussianClsSampler.from_data(self, batch_per_client,
                                                  local_steps)


def synthetic_lm_batch(key: prng.Key, batch: int, seq: int, vocab: int,
                       device="cuda") -> dict:
    """Pure-random tokens ``(batch, seq)`` in [0, vocab) on ``device``: the
    reference's ``jax.random.randint(key, (batch, seq), 0, vocab)`` bit for
    bit, as int64 (the port's index type) where the reference's are
    int32."""
    return {"tokens": prng.randint(key, (batch, seq), 0, vocab, device)}
