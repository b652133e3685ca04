"""Deterministic client fault injection, applied in sketch space.

Counterpart of ``repro/fed/faults.py``.  The participation layer decides
who is sampled; this module decides what a sampled client's payload looks
like when it misbehaves.  Three fault families act on the ``(G, b_total)``
uplink payload:

* **dropout after compute**: the payload never arrives; it folds into the
  aggregation mask like non-participation;
* **NaN / Inf corruption**: a poisoned payload, which ``fed.robust``'s
  finite check rejects;
* **Byzantine scaling**: the payload times a large factor, finite, which
  the norm-outlier sentinel catches.

A fault spec is a dict of ``(G,)`` tensors on the caller's device:
``arrive`` (float32 0/1), ``nan``/``inf`` (bool) and ``scale`` (float32,
1.0 for honest clients).  Every draw is ``uniform(fold_in(key_t, c))``
with ``key_t = fold_in(fold_in(key, 104729 + seed), t)``, bit for bit the
reference's stream, so the faults of round t do not depend on chunking,
on the driver or on a resume.  ``persistent=True`` keys the stream off
the config's seed alone, so a retried span sees the same faults.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import prng
from repro_torch.core.safl import _f32, mask_weights

_FAULT_STREAM_TAG = 104729   # decorrelates the fault stream from the data
                             # sampler, cohort and delay fold_in chains

# fault codes for FaultTable rows
OK, DROP, NAN, INF, BYZANTINE = 0, 1, 2, 3, 4


def _spec_from_codes(codes: torch.Tensor, byzantine_scale: float) -> dict:
    """Lower per-client int fault codes to a fault spec.  A no-fault spec
    is exactly neutral: a multiply by 1.0, a select on all-False and an
    all-ones ``arrive`` change no bit."""
    scale = torch.full(codes.shape, _f32(byzantine_scale), dtype=torch.float32,
                       device=codes.device)
    return {"arrive": (codes != DROP).to(torch.float32),
            "nan": codes == NAN,
            "inf": codes == INF,
            "scale": torch.where(codes == BYZANTINE, scale, 1.0)}


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Bernoulli per-(round, client) fault draws: each client-round draws
    one uniform u in [0, 1) and lands in the first matching interval,
    ``[0, drop)`` dropout, then NaN, Inf and Byzantine; the rest is honest.
    Faults fire only in rounds ``[start, stop)`` (``stop=None``: forever)."""
    num_clients: int
    drop_rate: float = 0.0
    nan_rate: float = 0.0
    inf_rate: float = 0.0
    byzantine_rate: float = 0.0
    byzantine_scale: float = 1e3
    start: int = 0
    stop: Optional[int] = None
    persistent: bool = False
    seed: int = 0

    def __post_init__(self):
        rates = (self.drop_rate, self.nan_rate, self.inf_rate,
                 self.byzantine_rate)
        if self.num_clients < 1:
            raise ValueError(f"num_clients must be >= 1, got {self.num_clients}")
        if not all(0.0 <= r <= 1.0 for r in rates):
            raise ValueError(f"fault rates must lie in [0, 1], got {rates}")
        if sum(rates) > 1.0:
            raise ValueError(f"fault rates must sum to <= 1, got {sum(rates)}")
        if not self.byzantine_scale > 0.0:
            raise ValueError(f"byzantine_scale must be > 0, got {self.byzantine_scale}")
        if self.start < 0 or (self.stop is not None and self.stop < self.start):
            raise ValueError(f"bad fault window [{self.start}, {self.stop})")

    def spec(self, t: int, base_key: prng.Key, device="cuda") -> dict:
        """The round-t fault spec, pure in (t, client, seed[, base_key])."""
        if self.persistent:
            key0 = prng.fold_in(prng.key(self.seed), _FAULT_STREAM_TAG)
        else:
            key0 = prng.fold_in(base_key, _FAULT_STREAM_TAG + self.seed)
        key_t = prng.fold_in(key0, int(t))
        u = prng.uniform_many([prng.fold_in(key_t, c)
                               for c in range(self.num_clients)], (), device)
        active = t >= self.start and (self.stop is None or t < self.stop)
        d = self.drop_rate
        n = d + self.nan_rate
        i = n + self.inf_rate
        b = i + self.byzantine_rate
        d, n, i, b = (_f32(x) for x in (d, n, i, b))
        drop = (u < d) & active
        nan = (u >= d) & (u < n) & active
        inf = (u >= n) & (u < i) & active
        byz = (u >= i) & (u < b) & active
        scale = torch.full_like(u, _f32(self.byzantine_scale))
        return {"arrive": 1.0 - drop.to(torch.float32),
                "nan": nan,
                "inf": inf,
                "scale": torch.where(byz, scale, 1.0)}


@dataclasses.dataclass(frozen=True)
class FaultTable:
    """Scripted faults: ``codes[t][c]`` is client c's fault code in round t.
    Rounds past the table are fault-free, or wrap with ``cyclic=True``."""
    codes: tuple
    byzantine_scale: float = 1e3
    cyclic: bool = False

    def __post_init__(self):
        if len(self.codes) < 1:
            raise ValueError("a fault table needs at least one round")
        if len({len(r) for r in self.codes}) != 1:
            raise ValueError("ragged fault table")
        if not all(OK <= c <= BYZANTINE for row in self.codes for c in row):
            raise ValueError(f"fault codes must lie in [{OK}, {BYZANTINE}]")
        if not self.byzantine_scale > 0.0:
            raise ValueError(f"byzantine_scale must be > 0, got {self.byzantine_scale}")

    @property
    def num_clients(self) -> int:
        return len(self.codes[0])

    def spec(self, t: int, base_key: prng.Key, device="cuda") -> dict:
        del base_key    # scripted faults are persistent by construction
        p = len(self.codes)
        if self.cyclic:
            row = self.codes[t % p]
        else:
            row = self.codes[t] if t < p else (OK,) * self.num_clients
        codes = torch.tensor(row, dtype=torch.int32, device=device)
        return _spec_from_codes(codes, self.byzantine_scale)


def corrupt_payload(spec: dict, payloads: torch.Tensor) -> torch.Tensor:
    """The spec's corruption of a ``(G, b)`` payload: the scale first, then
    the NaN/Inf replacement; the no-fault spec changes no bit."""
    s = payloads * spec["scale"][:, None].to(payloads.dtype)
    s = torch.where(spec["nan"][:, None], float("nan"), s)
    return torch.where(spec["inf"][:, None], float("inf"), s)


def take_rows(spec: dict, rows: torch.Tensor) -> dict:
    """A global (G,) fault spec cut down to a mesh rank's client ``rows``."""
    return {k: v[rows] for k, v in spec.items()}


def fold_arrivals(spec: dict, part_mask):
    """Fold dropout into the aggregation mask: a dropped client weighs 0,
    as if unsampled.  A weighted mask keeps its static denominator."""
    arrive = spec["arrive"]
    if part_mask is None:
        return arrive
    if isinstance(part_mask, dict):
        return {**part_mask, "w": part_mask["w"] * arrive}
    return part_mask * arrive


def n_dropped(spec: dict, part_mask) -> torch.Tensor:
    """Count (float32) of sampled clients whose payload never arrived."""
    w0 = (torch.ones_like(spec["arrive"]) if part_mask is None
          else mask_weights(part_mask))
    return torch.sum((w0 > 0) * (1.0 - spec["arrive"]))
