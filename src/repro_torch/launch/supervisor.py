"""Checkpoint-rollback supervisor: a host-side retry loop over the driver.

Counterpart of ``repro/launch/supervisor.py``.  The sentinels
(``fed.robust``) contain a client's fault inside a round; this layer
contains a whole run's divergence across rounds.  It wraps a chunked
launcher (``launch.driver.run_scan``) and, after every chunk, inspects
the chunk's history and the end-of-chunk parameters: a non-finite loss, a
loss above the divergence threshold, a fired ``diverged`` flag, or
non-finite parameters mark the chunk BAD.  On a bad chunk it

1. rolls back to a good ``(t, key)`` cursor: every per-round stream
   (data, cohorts, delays, faults, sketch operators) is a pure function
   of the absolute round index under the run key, so a relaunch from a
   snapshot replays the uninterrupted trajectory;
2. re-runs from there under the REKEYED run key
   ``fold_in(base_key, 0x5AFE + retry)``, which redraws every transient
   fault stream (``persistent=True`` faults re-fire and exhaust the
   budget); the port's threefry is jax's bit for bit, so a retried span's
   streams equal the reference's;
3. sleeps an exponential backoff between retries and gives up with a
   ``SupervisorError`` (carrying the recovery log) after ``max_retries``.

**Detection lag.**  A round's loss is measured before its own server
update, so a chunk whose last round diverges can pass while its
end-of-chunk parameters are already poisoned.  So the parameters are
finite-checked on the snapshot's host copy, and the supervisor keeps a
bounded stack of good snapshots: when a resume from a cursor faults
again, that snapshot is distrusted and the stack pops to the one before
(a deepening rollback).  The bottom is the run's initial state.

Snapshots are HOST copies (``.detach().to("cpu", copy=True)`` over nested
dicts; other leaves are kept as they are).  A relaunch moves the snapshot
back to the device of the run's parameters and checks that every tensor
leaf is there: a host tensor handed to a round would run the rest of the
run on the CPU.  The returned history is the concatenation of the good
chunks that stand at exit, and the recovery log is a list of
``{retry, t_fault, t_resume, reason}`` dicts.

**Over the mesh** (``mesh=``, ``launch.train.run_mesh_scan`` as the
launcher): every rank runs the supervisor on its own shards, and the
ranks agree on each verdict before any of them snapshots, checkpoints or
rolls back.  The verdict is one ``all_reduce`` (MIN) over the world
group of the smallest rank that saw a bad chunk -- its history (the same
on every rank), a fired flag, or non-finite values in its own shards --
and that rank's reason reaches the others through
``broadcast_object_list``.  So every rank raises the same fault, pops the
same snapshot and rekeys with the same key; a rank that rewound alone
would leave the others' collectives waiting for rounds it no longer runs.
Snapshots stay each rank's host copies of its shards.  ``ckpt_path``
writes the whole tree in the reference's layout: every rank takes part in
one ``gather_tree`` of the chunk's shards, and rank 0 writes, so the
one-process loader resumes from it.  Recovery events go to ``stream`` on
rank 0 only, as the mesh driver's shards do.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Mapping

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import prng

# decorrelates retry keys from the per-round fold_in(key, t) chain (round
# indices are small ints; retry counts are added to this tag)
_REKEY_TAG = 0x5AFE


@dataclasses.dataclass(frozen=True)
class SupervisorConfig:
    """``divergence=0`` treats only non-finite signals (and fired sentinel
    flags) as faults; a positive threshold also catches finite loss
    blow-ups.  ``backoff_s`` is the base of the exponential sleep between
    retries.  ``keep_snapshots`` bounds rollback memory: the initial state
    plus the most recent K-1 good cursors."""
    max_retries: int = 3
    backoff_s: float = 0.0
    divergence: float = 0.0
    keep_snapshots: int = 8

    def __post_init__(self):
        assert self.max_retries >= 0
        assert self.backoff_s >= 0.0
        assert self.divergence >= 0.0
        assert self.keep_snapshots >= 2


class SupervisorError(RuntimeError):
    """Raised when the retry budget is exhausted; ``.log`` holds the full
    recovery log (every rollback attempted, with its reason)."""

    def __init__(self, msg: str, log: list):
        super().__init__(msg)
        self.log = log


class _ChunkFault(Exception):
    def __init__(self, t_done: int, reason: str):
        super().__init__(reason)
        self.t_done = t_done
        self.reason = reason


def chunk_is_bad(hist: dict, divergence: float = 0.0):
    """``(bad, reason)`` for a chunk's host history: the signals the
    ``diverged`` sentinel flags, evaluated where the run can be stopped."""
    loss = np.asarray(hist.get("loss", np.zeros((0,))))
    finite = np.isfinite(loss)
    if not finite.all():
        i = int(np.argmin(finite))
        return True, f"non-finite loss at chunk offset {i}"
    if divergence > 0.0 and (loss > divergence).any():
        i = int(np.argmax(loss > divergence))
        return True, (f"loss {float(loss[i]):.4g} above divergence "
                      f"threshold {divergence:g} at chunk offset {i}")
    flags = np.asarray(hist.get("diverged", np.zeros((0,))))
    if flags.size and (flags > 0).any():
        i = int(np.argmax(flags > 0))
        return True, f"divergence sentinel fired at chunk offset {i}"
    return False, ""


def _map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _host(tree):
    return _map(lambda x: x.detach().to("cpu", copy=True), tree)


def _tensors(tree) -> list[torch.Tensor]:
    if isinstance(tree, Mapping):
        return [x for v in tree.values() for x in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _finite_tree(tree) -> bool:
    return all(bool(torch.isfinite(x).all()) for x in _tensors(tree)
               if x.is_floating_point())


def _on_device(tree, device: torch.device, what: str) -> None:
    off = {str(x.device) for x in _tensors(tree)} - {str(device)}
    if off:
        raise RuntimeError(f"supervisor: {what} on {sorted(off)}, not on the "
                           f"run's device {device}")


def _agree(mesh, bad: bool, reason: str) -> tuple[bool, str]:
    """The mesh's verdict on a chunk, the same on every rank: bad if any
    rank found it bad, with the reason of the smallest such rank.  One
    ``all_reduce`` of that rank's index over the world group, then, for a
    bad chunk, its reason broadcast as an object.  Without a mesh, this
    rank's own verdict."""
    if mesh is None or mesh.size == 1:
        return bad, reason
    first = torch.tensor([mesh.rank if bad else mesh.size], dtype=torch.int64,
                         device=mesh.device)
    dist.all_reduce(first, op=dist.ReduceOp.MIN)
    src = int(first.item())
    if src == mesh.size:
        return False, ""
    box = [reason]
    dist.broadcast_object_list(box, src=src)
    return True, box[0]


def _state_pspecs(state, pspecs):
    """The specs of a server state laid out as ``launch.train.opt_pspecs``
    does: every dict keyed like the params takes ``pspecs``, every other
    leaf is replicated."""
    if isinstance(state, Mapping):
        if state and set(state) == set(pspecs):
            return pspecs
        return {k: _state_pspecs(v, pspecs) for k, v in state.items()}
    return ()


def run_supervised(launch: Callable, params, state, *, rounds: int,
                   key: prng.Key, config: SupervisorConfig | None = None,
                   on_chunk=None, ckpt_path: str | None = None,
                   start_round: int = 0, stream=None, mesh=None,
                   pspecs=None):
    """Supervise a chunked driver run with rollback-and-rekey retries.

    ``launch(params, state, *, key, start_round, on_chunk) -> (params,
    state, hist)`` adapts the driver, e.g.::

        launch = lambda p, s, *, key, start_round, on_chunk: run_scan(
            round_fn, sampler, p, s, rounds=R, key=key, chunk_size=C,
            start_round=start_round, on_chunk=on_chunk, faults=faults)

    The supervisor owns the driver's ``on_chunk`` slot; the caller's
    ``on_chunk(t_done, params, state, hist)`` still runs for every chunk
    that passes.  ``ckpt_path`` saves each good ``(t, key)`` cursor through
    ``checkpoint.save_checkpoint``, the key as the reference's
    ``key_data`` (two uint32), so the checkpoint restores in either
    package.  ``start_round`` seeds the root snapshot of a run resumed
    from a cursor: rollbacks bottom out there.

    ``stream`` (an ``obs.shards.ShardWriter``, normally the one handed to
    the driver) receives each rollback as a ``recovery`` event (retry,
    cursors, depth, rekey tag), and the supervisor keeps no history of its
    own: the shards are the record, a retried span re-emits its rounds in
    new shards, and the returned ``history`` is ``{}``.

    ``mesh`` (a live ``launch.mesh.Mesh``) supervises a mesh run on this
    rank's shards (module docstring); ``params``/``state`` are then the
    rank's shards and ``pspecs`` their specs, which a checkpoint of the
    whole tree needs.  Every rank of the mesh must call it.

    Returns ``(params, state, history, recovery_log)``."""
    config = config or SupervisorConfig()
    if mesh is not None and ckpt_path is not None and pspecs is None:
        raise ValueError("a mesh checkpoint gathers the whole tree: pass the "
                         "shards' pspecs")
    lead = mesh is None or mesh.rank == 0
    device = _tensors(params)[0].device
    base_key = key
    cur_key = key
    snaps = [{"t": int(start_round), "params": _host(params),
              "state": _host(state)}]
    hists: list = []      # (t_start, t_end, hist) of good chunks that stand
    log: list = []
    retries = 0
    last_resume = None    # cursor of the most recent rollback, if any

    def sup_on_chunk(t_done, p, s, hist):
        _on_device({"params": p, "state": s}, device,
                   "the chunk's parameters and state")
        bad, reason = chunk_is_bad(hist, config.divergence)
        hp = hs = None
        if not bad:
            hp, hs = _host(p), _host(s)
            if not _finite_tree(hp):
                # detection lag: the last round's loss predates its own
                # poisoned server update -- never snapshot a non-finite cursor
                bad, reason = True, "non-finite params at chunk end"
        bad, reason = _agree(mesh, bad, reason)
        if bad:
            raise _ChunkFault(t_done, reason)
        t_start = snaps[-1]["t"]
        snaps.append({"t": t_done, "params": hp, "state": hs})
        if len(snaps) > config.keep_snapshots:
            del snaps[1]          # keep the initial state as the root
        if stream is None:        # streamed runs: the shards are the record
            hists.append((t_start, t_done, hist))
        if ckpt_path is not None:
            from repro_torch.checkpoint.io import save_checkpoint
            cp, cs = hp, hs
            if mesh is not None:        # the whole tree, written by rank 0
                from repro_torch.models.sharding import gather_tree
                cp = _host(gather_tree(mesh, p, pspecs))
                cs = _host(gather_tree(mesh, s, _state_pspecs(s, pspecs)))
            if lead:
                save_checkpoint(
                    ckpt_path,
                    {"params": cp, "opt": cs,
                     "cursor": {"t": np.asarray(t_done),
                                "key": np.asarray(cur_key, dtype=np.uint32)}},
                    step=t_done)
        if on_chunk is not None:
            on_chunk(t_done, p, s, hist)

    # the first launch takes the caller's tensors; no other reference is
    # kept, so a relaunch leaves them to the caller
    p_in, s_in = params, state
    del params, state
    while True:
        top = snaps[-1]
        try:
            p_out, s_out, _ = launch(p_in, s_in, key=cur_key,
                                     start_round=top["t"],
                                     on_chunk=sup_on_chunk)
            bad, reason = _agree(mesh, not _finite_tree(p_out),
                                 "non-finite final params")
            if bad:
                raise _ChunkFault(rounds, reason)
        except _ChunkFault as f:
            retries += 1
            if retries > config.max_retries:
                raise SupervisorError(
                    f"retry budget exhausted ({config.max_retries}) after "
                    f"fault at round < {f.t_done}: {f.reason}", log)
            if config.backoff_s > 0.0:
                time.sleep(config.backoff_s * 2.0 ** (retries - 1))
            if snaps[-1]["t"] == last_resume and len(snaps) > 1:
                # resuming from this cursor already faulted once: the
                # snapshot itself may sit inside the blast radius -- deepen
                snaps.pop()
            t_res = snaps[-1]["t"]
            hists[:] = [h for h in hists if h[1] <= t_res]
            last_resume = t_res
            cur_key = prng.fold_in(base_key, _REKEY_TAG + retries)
            log.append({"retry": retries, "t_fault": int(f.t_done),
                        "t_resume": int(t_res), "reason": f.reason})
            if stream is not None and lead:
                stream.write_event(
                    "recovery", retry=retries, t_fault=int(f.t_done),
                    t_resume=int(t_res),
                    depth=int(f.t_done) - int(t_res), reason=f.reason,
                    rekey=_REKEY_TAG + retries)
        else:
            history = ({k: np.concatenate([h[k] for _, _, h in hists])
                        for k in hists[0][2]} if hists else {})
            return p_out, s_out, history, log
        # relaunch from the snapshot on the run's device (outside the
        # handler, so the faulted run's tensors are already freed)
        p_in = s_in = None
        p_in = _map(lambda x: x.to(device, copy=True), snaps[-1]["params"])
        s_in = _map(lambda x: x.to(device, copy=True), snaps[-1]["state"])
        _on_device({"params": p_in, "state": s_in}, device,
                   "the relaunched snapshot")


def format_recovery_log(log: list) -> str:
    """Human-readable recovery report (``launch/train_lm.py`` prints it)."""
    if not log:
        return "supervisor: clean run, no rollbacks"
    lines = [f"supervisor: {len(log)} rollback(s)"]
    for e in log:
        lines.append(
            f"  retry {e['retry']}: fault before round {e['t_fault']} "
            f"({e['reason']}); resumed from round {e['t_resume']} with "
            f"rekeyed streams")
    return "\n".join(lines)
