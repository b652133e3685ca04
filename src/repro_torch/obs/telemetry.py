"""Round telemetry probes.

Counterpart of ``repro/obs/telemetry.py``.  A ``Telemetry`` config is a
static switch bound into a round function with ``functools.partial``,
like ``plan=`` and ``sentinel=``.  When bound, the round computes the
selected probe scalars next to the loss and returns them in its metrics;
the driver stacks them into the chunk's history like any other key, and
``obs.shards.ShardWriter`` writes them as JSONL rows.  ``telemetry=None``
(the default) adds nothing to a round: its arithmetic is the same,
operation for operation.

The probes (float32 scalars, one a round):

* ``delta_norm``  -- l2 norm of the cohort-mean client delta Δ̄;
* ``update_norm`` -- l2 norm of the applied server update desk(sk(Δ̄));
* ``residual``    -- ‖Δ̄ − desk(sk(Δ̄))‖ / ‖Δ̄‖, the paper's sketch-noise
  observable (about sqrt(d/b) for the unbiased families, exactly 0 for
  the uncompressed FedOPT round);
* ``m_norm`` / ``v_norm`` / ``vhat_norm`` -- the server's moment norms
  after the round's ADA_OPT step;
* ``ef_norm``     -- the error-feedback memory's norm, for the baselines
  that carry one (``err``, or FetchSGD's ``sk_err``);
* ``cohort``      -- the clients with weight > 0 in the round's effective
  mask, after faults and sentinels;
* ``clip_frac``   -- the cohort's share whose pre-clip delta norm
  exceeded tau (SACFL rounds only).

Norms accumulate in float32 as the reference's do: one sum of squares a
leaf, summed over the leaves in the reference's leaf order (jax's
flatten order of the nested dict), then ``sqrt``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch

from repro_torch.checkpoint.io import _leaf_paths

# every probe key a telemetry history or shard row may carry;
# ``launch.driver.HISTORY_KEYS`` builds on it
PROBE_KEYS = ("delta_norm", "update_norm", "residual", "m_norm", "v_norm",
              "vhat_norm", "ef_norm", "cohort", "clip_frac")


@dataclasses.dataclass(frozen=True)
class Telemetry:
    """Per-probe switches; ``Telemetry()`` enables them all.  A probe
    appears only when its switch is on and the round can supply it
    (``clip_frac`` only from SACFL rounds, ``ef_norm`` only from the
    baselines with an EF memory)."""
    delta_norm: bool = True
    update_norm: bool = True
    residual: bool = True
    moments: bool = True
    cohort: bool = True
    clip: bool = True


def tree_leaves(tree: Any) -> list[torch.Tensor]:
    """The tensors of a tree (a tensor, or nested dicts of them with
    "/"-joined keys) in jax's flatten order: paths sorted component by
    component."""
    if not isinstance(tree, Mapping):
        return [tree]
    return [leaf for _, leaf in _leaf_paths(tree)]


def tree_norm(tree: Any) -> torch.Tensor:
    """Global l2 norm of a tree (float32 accumulation)."""
    sq = sum(torch.sum(torch.square(x.to(torch.float32)))
             for x in tree_leaves(tree))
    return torch.sqrt(sq)


def effective_cohort(part_mask, num_clients: int, device) -> torch.Tensor:
    """Clients with aggregation weight > 0 (after faults and sentinels)."""
    from repro_torch.core.safl import mask_weights
    if part_mask is None:
        return torch.tensor(float(num_clients), dtype=torch.float32,
                            device=device)
    w = mask_weights(part_mask)
    return torch.sum((w > 0).to(torch.float32))


def state_norms(state) -> dict:
    """Moment and EF-memory norms of a server state: ``m``/``v``/``vhat``
    of the ADA_OPT state (possibly nested under ``"opt"``, the baselines'
    layout), and the baselines' ``err``/``sk_err`` memories."""
    if not isinstance(state, Mapping):
        return {}
    opt = state.get("opt", state)
    out = {}
    if isinstance(opt, Mapping):
        for key, name in (("m", "m_norm"), ("v", "v_norm"),
                          ("vhat", "vhat_norm")):
            if key in opt:
                out[name] = tree_norm(opt[key])
    ef = state.get("err", state.get("sk_err"))
    if ef is not None:
        out["ef_norm"] = tree_norm(ef)
    return out


def telemetry_probes(tel: Telemetry, *, deltas=None, update=None,
                     part_mask=None, state=None, clip_frac=None) -> dict:
    """The selected probe scalars of one round.

    ``deltas`` leaves are the (G, ...) per-client deltas, ``update`` the
    applied server update, ``part_mask`` the round's EFFECTIVE mask (after
    ``guard_uplink``), ``state`` the server state after the update.  An
    absent input drops its probes.  Every value is a float32 scalar tensor
    on the round's device."""
    from repro_torch.core.safl import masked_mean_tree
    out = {}
    dbar = dn = None
    if deltas is not None and (tel.delta_norm or tel.residual):
        dbar = masked_mean_tree(deltas, part_mask)
        dn = tree_norm(dbar)
        if tel.delta_norm:
            out["delta_norm"] = dn
    if tel.update_norm and update is not None:
        out["update_norm"] = tree_norm(update)
    if tel.residual and dbar is not None and update is not None:
        diff = {k: a - update[k].to(torch.float32) for k, a in dbar.items()}
        out["residual"] = tree_norm(diff) / torch.clamp(dn, min=1e-12)
        del diff
    if tel.moments and state is not None:
        out.update(state_norms(state))
    if tel.cohort and deltas is not None:
        first = tree_leaves(deltas)[0]
        out["cohort"] = effective_cohort(part_mask, first.shape[0], first.device)
    if tel.clip and clip_frac is not None:
        out["clip_frac"] = clip_frac
    return {k: v.to(torch.float32) for k, v in out.items()}
