"""Learning-rate schedules (paper Appendix D uses cosine on the server;
Theorem 3.2/B.3 analyze constant and 1/sqrt(t) decays).

Counterpart of ``repro/optim/schedules.py``.  A schedule maps a round
index to a multiplier, computed in float32 operation by operation as the
reference computes it on its traced round index, and returned as a
Python float (exactly that float32 value): the driver calls it on the
host with the round index, so it never waits on the device.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np

Schedule = Callable[[int], float]  # round index -> float32 multiplier

_F32 = np.float32


def constant() -> Schedule:
    return lambda t: 1.0


def inv_sqrt(t0: float = 1.0) -> Schedule:
    """eta_t = 1 / sqrt(t + t0): the decay analyzed in Theorem B.3."""
    return lambda t: float(_F32(1.0) / np.sqrt(_F32(t) + _F32(t0)))


def cosine(total_steps: int, min_frac: float = 1e-3,
           warmup: int = 0) -> Schedule:
    """Cosine decay to min_frac with optional linear warmup (paper App. D)."""
    def fn(t) -> float:
        t = _F32(t)
        warm = (min(t / _F32(max(warmup, 1)), _F32(1.0)) if warmup
                else _F32(1.0))
        frac = np.clip((t - _F32(warmup)) / _F32(max(total_steps - warmup, 1)),
                       _F32(0.0), _F32(1.0))
        cos = _F32(min_frac) + _F32((1 - min_frac) * 0.5) * (
            _F32(1.0) + np.cos(_F32(math.pi) * frac))
        return float(warm * cos)
    return fn


def sketch_size_schedule(base_ratio: float, total_steps: int,
                         final_frac: float = 1.0) -> Callable[[int], float]:
    """Beyond-paper: anneal the sketch ratio over rounds (DESIGN §7.2).
    The sketch size fixes the packing plan's shapes, so a trainer builds a
    new plan per phase of the schedule."""
    def fn(step: int) -> float:
        frac = min(max(step / max(total_steps, 1), 0.0), 1.0)
        return base_ratio * (1.0 + (final_frac - 1.0) * frac)
    return fn
