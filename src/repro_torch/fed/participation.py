"""Client participation policies: who reports in round t.

Counterpart of ``repro/fed/participation.py``.  A policy's ``mask(t,
device)`` is the round-t cohort as a ``(num_clients,)`` float32 0/1 mask,
or, for ``ImportanceParticipation``, the weighted dict ``{"w", "den",
"n"}``; the round functions take it as ``part_mask`` and the server's mean
over the packed ``(G, b_total)`` payload divides by the sampled cohort
(``core.safl.masked_mean``).

* **Pure in t.**  Randomized cohorts derive from
  ``uniform(fold_in(fold_in(key(seed), t), c))`` (``prng``, bit for bit
  the reference's stream), so the mask of round t does not depend on
  chunking, on earlier rounds or on how a run was resumed.
* **Bitwise the reference's.**  The cohort is the m smallest variates
  under a stable sort, as ``jnp.argsort`` ranks them, so masks are
  integer-valued outputs equal to the reference's bit for bit.
* **Never empty.**  Every policy samples at least one client per round
  (asserted at construction).

In simulation every client still computes; the mask decides what the
server aggregates.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.safl import masked_mean, masked_mean_tree  # noqa: F401


def is_weighted_mask(mask) -> bool:
    """True for the weighted dict mask form (``{"w", "den", "n"}``) emitted
    by ``ImportanceParticipation``."""
    return isinstance(mask, dict)


def check_policy_clients(policy, num_clients: int, where: str) -> None:
    """Fail fast when a policy's client universe does not match the
    driver's: the mask is positional, so a mismatch would sample cohorts
    over the wrong index set."""
    n = getattr(policy, "num_clients", None)
    if n is not None and int(n) != int(num_clients):
        raise ValueError(
            f"{where}: participation policy covers {n} clients but the "
            f"driver runs {num_clients} -- build the policy with "
            f"num_clients={num_clients}")


def round_variates(num_clients: int, seed: int, t: int,
                   device="cuda") -> torch.Tensor:
    """Per-(round, client) uniforms shared by the randomized policies:
    ``u_c = uniform(fold_in(fold_in(key(seed), t), c))``, a pure function
    of ``(t, c, seed)``; client c's variate does not depend on how many
    other clients exist."""
    key_t = prng.fold_in(prng.key(seed), int(t))
    keys = [prng.fold_in(key_t, c) for c in range(num_clients)]
    return prng.uniform_many(keys, (), device)


def _cohort(z: torch.Tensor, m: int) -> torch.Tensor:
    """The 0/1 mask of the m smallest entries of z, ties in index order."""
    order = torch.argsort(z, stable=True)
    sel = torch.zeros(z.shape, dtype=torch.float32, device=z.device)
    sel[order[:m]] = 1.0
    return sel


@dataclasses.dataclass(frozen=True)
class UniformParticipation:
    """Uniform-without-replacement cohort of fixed size m per round: the m
    clients with the smallest round-t variates."""
    num_clients: int
    frac: float = 0.25          # sampled fraction; cohort m = round(frac*N)
    seed: int = 0

    def __post_init__(self):
        assert self.num_clients >= 1
        assert 0.0 < self.frac <= 1.0, f"frac {self.frac} not in (0, 1]"
        assert self.cohort_size >= 1, "policy must sample >=1 client"

    @property
    def cohort_size(self) -> int:
        return max(1, int(round(self.frac * self.num_clients)))

    def variates(self, t: int, device="cuda") -> torch.Tensor:
        return round_variates(self.num_clients, self.seed, t, device)

    def mask(self, t: int, device="cuda") -> torch.Tensor:
        return _cohort(self.variates(t, device), self.cohort_size)


@dataclasses.dataclass(frozen=True)
class ImportanceParticipation:
    """Non-uniform client sampling with 1/(N p_c) importance reweighting.

    The round-t cohort is the m smallest keys ``z_c = -log1p(-u_c) /
    (N p_c)`` over the uniforms ``UniformParticipation`` draws (the
    exponential race of weighted sampling without replacement), and the
    mask is ``{"w": 1{c in S} / (N p_c), "den": m, "n": m}``: the
    Horvitz-Thompson estimator with the static denominator m.  The
    constructor rejects ``m * max(p_c) > 1``, where the inclusion
    approximation ``pi_c ~= m p_c`` saturates.  Uniform probabilities are
    detected statically: the tilt is then the identity and every weight
    exactly 1.0, so the mask equals ``UniformParticipation``'s with the
    same (frac, seed) in value.

    The keys are float32 as in the reference: ``log1p`` is taken in
    float64 and rounded to float32 (the correctly rounded value), then
    divided by the float32 rates in float32.
    """
    num_clients: int
    probs: tuple[float, ...]    # per-client sampling distribution (sums to 1)
    frac: float = 0.25
    seed: int = 0

    def __post_init__(self):
        assert self.num_clients >= 1
        assert len(self.probs) == self.num_clients, \
            f"need {self.num_clients} probs, got {len(self.probs)}"
        assert all(p > 0.0 for p in self.probs), "probs must be positive"
        assert abs(sum(self.probs) - 1.0) < 1e-6, "probs must sum to 1"
        assert 0.0 < self.frac <= 1.0, f"frac {self.frac} not in (0, 1]"
        assert self.cohort_size >= 1, "policy must sample >=1 client"
        assert self.cohort_size * max(self.probs) <= 1.0 + 1e-9, (
            f"cohort {self.cohort_size} x max prob {max(self.probs)} > 1: "
            "the pi_c ~= m p_c inclusion approximation saturates and the "
            "1/(N p_c) reweighting becomes severely biased -- shrink frac "
            "or flatten probs")

    @property
    def cohort_size(self) -> int:
        return max(1, int(round(self.frac * self.num_clients)))

    @property
    def uniform(self) -> bool:
        """Statically detected uniform distribution: identity tilt, unit
        weights."""
        return len(set(self.probs)) == 1

    def variates(self, t: int, device="cuda") -> torch.Tensor:
        return round_variates(self.num_clients, self.seed, t, device)

    def _np_rates(self) -> np.ndarray:
        return (self.num_clients
                * np.asarray(self.probs, np.float64)).astype(np.float32)

    def mask(self, t: int, device="cuda") -> dict:
        u = self.variates(t, device)
        if self.uniform:
            z = u
            w = torch.ones((self.num_clients,), dtype=torch.float32,
                           device=device)
        else:
            rates = torch.as_tensor(self._np_rates(), device=device)
            z = -torch.log1p(-u.to(torch.float64)).to(torch.float32) / rates
            w = torch.as_tensor((1.0 / self._np_rates().astype(np.float64))
                                .astype(np.float32), device=device)
        m = self.cohort_size
        return {"w": _cohort(z, m) * w, "den": float(m), "n": m}


@dataclasses.dataclass(frozen=True)
class FixedCohort:
    """A static cohort: the same client subset reports every round."""
    num_clients: int
    clients: tuple[int, ...] = (0,)

    def __post_init__(self):
        assert len(self.clients) >= 1, "policy must sample >=1 client"
        assert all(0 <= c < self.num_clients for c in self.clients)

    @property
    def cohort_size(self) -> int:
        return len(set(self.clients))

    def mask(self, t: int, device="cuda") -> torch.Tensor:
        m = np.zeros((self.num_clients,), np.float32)
        m[list(self.clients)] = 1.0
        return torch.as_tensor(m, device=device)


@dataclasses.dataclass(frozen=True)
class AvailabilityTrace:
    """Cyclic availability: round t's cohort is row ``t % P`` of a fixed
    (P, num_clients) 0/1 trace.  ``round_robin`` builds the cyclic split
    where client c is available iff ``c % groups == t % groups``."""
    trace: tuple[tuple[float, ...], ...]     # (P, N) rows of 0/1

    def __post_init__(self):
        assert len(self.trace) >= 1
        n = len(self.trace[0])
        assert all(len(row) == n for row in self.trace)
        assert all(sum(row) >= 1 for row in self.trace), \
            "every trace row must have >=1 available client"

    @classmethod
    def round_robin(cls, num_clients: int, groups: int) -> "AvailabilityTrace":
        assert 1 <= groups <= num_clients
        rows = tuple(tuple(1.0 if c % groups == g else 0.0
                           for c in range(num_clients))
                     for g in range(groups))
        return cls(trace=rows)

    @property
    def num_clients(self) -> int:
        return len(self.trace[0])

    @property
    def cohort_size(self) -> int:
        """Largest per-round cohort (upper bound for bits accounting)."""
        return int(max(sum(row) for row in self.trace))

    def mask(self, t: int, device="cuda") -> torch.Tensor:
        row = self.trace[int(t) % len(self.trace)]
        return torch.tensor(row, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class FullParticipation:
    """All N clients every round -- the paper's setting, as a policy.  Its
    all-ones mask is bit for bit the round without a mask."""
    num_clients: int

    def __post_init__(self):
        assert self.num_clients >= 1

    @property
    def cohort_size(self) -> int:
        return self.num_clients

    def mask(self, t: int, device="cuda") -> torch.Tensor:
        return torch.ones((self.num_clients,), dtype=torch.float32,
                          device=device)
