"""Sketch-space payload sentinels: graceful degradation before aggregation.

Counterpart of ``repro/fed/robust.py``.  Every uplink arrives as one row
of the packed ``(G, b_total)`` payload, so validating a client costs
O(b_total) whatever the model's d, and a rejected client folds into the
participation mask with weight 0: the round still takes one masked mean.

The order is **faults -> sentinels -> mask -> one mean**.  The sentinels

1. finite-check each row and zero the rejected ones (``0 * NaN`` is NaN,
   so masking alone would not contain a poisoned row);
2. optionally reject norm outliers: rows whose squared sketch norm exceeds
   ``norm_mult**2`` times the lower median of the arrived, finite, sampled
   rows' (a Byzantine-scaled payload is visible in sketch space);
3. carry the server's params and state through unchanged when no client
   survives (an all-zero mean would still move an adaptive server);
4. flag loss divergence (non-finite, or above ``divergence``).

With no fault and finite payloads every sentinel op is an identity, and
the port routes ``sentinel=None`` in Python, so a guarded clean round of
the port equals its unguarded round bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core.safl import _f32, mask_weights
from repro_torch.fed.faults import corrupt_payload, fold_arrivals, n_dropped


@dataclasses.dataclass(frozen=True)
class SentinelConfig:
    """``norm_mult=0`` disables norm-outlier rejection (the finite check is
    always on); ``divergence=0`` flags only non-finite losses."""
    norm_mult: float = 10.0
    divergence: float = 0.0

    def __post_init__(self):
        if self.norm_mult < 0.0 or self.divergence < 0.0:
            raise ValueError("norm_mult and divergence must be >= 0")


def masked_median(x: torch.Tensor, pool: torch.Tensor) -> torch.Tensor:
    """Lower median of ``x`` over ``pool`` (bool): sort with the others at
    +inf and take index ``(n_pool - 1) // 2``; +inf on an empty pool."""
    srt = torch.sort(torch.where(pool, x, float("inf"))).values
    n = torch.sum(pool).to(torch.int64)
    return srt.index_select(0, (torch.clamp(n - 1, min=0) // 2).reshape(1))[0]


def norm_bound(scfg: SentinelConfig, med2: torch.Tensor) -> torch.Tensor:
    """``norm_mult**2 * med2``, the multiplier rounded to float32 first."""
    return _f32(scfg.norm_mult ** 2) * med2


def _valid_rows(scfg: SentinelConfig, payloads: torch.Tensor,
                w_arr: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row verdicts and the finite-zeroed payload.  The median pools
    only arrived, finite, sampled rows (``w_arr`` is the post-arrival
    weight), so a NaN-rejected client and the same client dropped see the
    same median."""
    ok = torch.isfinite(payloads).all(dim=-1)
    clean = torch.where(ok[:, None], payloads, 0.0)
    valid = ok
    if scfg.norm_mult > 0.0:
        nrm2 = torch.sum(torch.square(clean), dim=-1)
        med2 = masked_median(nrm2, (w_arr > 0) & ok)
        valid = valid & (nrm2 <= norm_bound(scfg, med2))
    return valid, clean


def _fold_valid(part_mask, valid: torch.Tensor):
    v = valid.to(torch.float32)
    if part_mask is None:
        return v
    if isinstance(part_mask, dict):
        return {**part_mask, "w": part_mask["w"] * v}
    return part_mask * v


def mask_wsum(mask) -> torch.Tensor:
    """Total surviving cohort weight (a scalar) of an effective mask."""
    return torch.sum(mask_weights(mask))


def guard_uplink(payloads: torch.Tensor, part_mask, fault_spec,
                 sentinel: Optional[SentinelConfig]):
    """The fault and sentinel chain on a full ``(G, b_total)`` payload.
    Returns ``(payloads, eff_mask, counters)``: the mask with fault drops
    and sentinel rejections folded in, and ``{"n_dropped", "n_rejected"}``
    (those of the hooks given)."""
    counters = {}
    if fault_spec is not None:
        counters["n_dropped"] = n_dropped(fault_spec, part_mask)
        payloads = corrupt_payload(fault_spec, payloads)
        part_mask = fold_arrivals(fault_spec, part_mask)
    if sentinel is not None:
        w_arr = (torch.ones(payloads.shape[0], dtype=torch.float32,
                            device=payloads.device)
                 if part_mask is None else mask_weights(part_mask))
        valid, payloads = _valid_rows(sentinel, payloads, w_arr)
        counters["n_rejected"] = torch.sum((w_arr > 0) & ~valid).to(torch.int32)
        part_mask = _fold_valid(part_mask, valid)
    return payloads, part_mask, counters


def tree_where(cond: torch.Tensor, a, b):
    """``where(cond, a, b)`` leaf by leaf over matching nests of dicts,
    tuples and lists of tensors."""
    if isinstance(a, dict):
        return {k: tree_where(cond, a[k], b[k]) for k in a}
    if isinstance(a, (tuple, list)):
        return type(a)(tree_where(cond, x, y) for x, y in zip(a, b))
    return torch.where(cond, a, b)


def carry_if_empty(eff_mask, new: tuple, old: tuple) -> tuple:
    """If no client survived the mask fusion keep ``old`` (the params and
    server state), else ``new``; a select, so the non-empty path is
    ``new`` bit for bit."""
    return tree_where(mask_wsum(eff_mask) == 0, old, new)


def divergence_flag(scfg: SentinelConfig, loss: torch.Tensor) -> torch.Tensor:
    """0/1 (float32) loss-divergence flag for the metric history."""
    bad = ~torch.isfinite(loss)
    if scfg.divergence > 0.0:
        bad = bad | (loss > _f32(scfg.divergence))
    return bad.to(torch.float32)


def sentinel_validity(scfg: SentinelConfig, payload_loc: torch.Tensor,
                      rows: torch.Tensor, w_arr: torch.Tensor,
                      num_clients: int, group=None):
    """The sentinel's verdicts on a mesh rank's ``(G_loc, b_loc)`` payload
    slice (its client ``rows``, one model shard of each row), the same on
    every rank.  A client is finite only if every shard of its row is, and
    its squared norm is the sum of its shards', so the two ``(G,)`` stats
    arrays cross ONE ``all_reduce`` over ``group``, the group of every mesh
    axis (client axes join disjoint rows, the others join shards of a row).
    Where every model rank holds the whole row (``cross_device_dp``) the
    stats come out multiplied by the model axis's size, as in the
    reference: the norm test is scale-free and ``bad`` is only compared
    with 0.

    Returns ``(valid (G,), clean_loc, n_rejected)``: the local slice with
    its non-finite rows zeroed (a row bad only on another rank gets weight
    0 from ``valid``)."""
    ok_loc = torch.isfinite(payload_loc).all(dim=-1)
    clean_loc = torch.where(ok_loc[:, None], payload_loc, 0.0)
    stats = torch.zeros((2, num_clients), dtype=torch.float32,
                        device=payload_loc.device)
    stats[0].index_add_(0, rows, (~ok_loc).to(torch.float32))
    stats[1].index_add_(0, rows, torch.sum(torch.square(clean_loc), dim=-1)
                        .to(torch.float32))
    if group is not None:
        dist.all_reduce(stats, group=group)
    bad, nrm2 = stats[0], stats[1]
    valid = bad == 0
    if scfg.norm_mult > 0.0:
        med2 = masked_median(nrm2, (w_arr > 0) & valid)
        valid = valid & (nrm2 <= norm_bound(scfg, med2))
    n_rejected = torch.sum((w_arr > 0) & ~valid).to(torch.int32)
    return valid, clean_loc, n_rejected
