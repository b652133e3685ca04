"""Streamed per-chunk metric shards and the run's event log.

Counterpart of ``repro/obs/shards.py``, with the same file formats byte
for byte.  The driver hands each chunk's history to a ``ShardWriter``,
which

* appends one JSONL shard per chunk (``metrics-00000.jsonl``, one row a
  round: ``{"kind": "metrics", "t": <absolute round>, "loss": ...,
  <probe and counter keys>}``), and
* keeps O(1) running aggregates (per-key sum, count and last value), so
  the end-of-run summary needs no replay.

Every per-round stream is a pure function of the absolute round index,
so the rows of a chunked run equal a one-chunk run's: shard boundaries
are an I/O artifact.

``events.jsonl`` in the same directory holds wall-time spans per chunk
(``{"kind": "span", "t0", "t1", "seconds", "compile"}``, where
``compile: true`` marks the first chunk of each length) and the
supervisor's recovery events (``{"kind": "recovery", "retry", "t_fault",
"t_resume", "depth", "reason", "rekey"}``).  A retried span re-emits its
rounds in new shards; readers resolve a repeated ``t`` last-wins.

``tools/check_telemetry.py`` validates the formats;
``python -m repro_torch.obs.report RUN_DIR`` renders a run directory.
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping

import numpy as np
import torch


def host_fetch(tree: Any) -> Any:
    """A metric history (nested dicts of tensors) on the host as numpy:
    the copies of every CUDA leaf start first (``non_blocking`` into
    pinned buffers), then one synchronise waits for them all."""
    cuda = []

    def start(x):
        if isinstance(x, Mapping):
            return {k: start(v) for k, v in x.items()}
        if isinstance(x, torch.Tensor):
            x = x.detach()
            if x.is_cuda:
                buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                buf.copy_(x, non_blocking=True)
                cuda.append(x.device)
                return buf
        return x

    staged = start(tree)
    for device in set(cuda):
        torch.cuda.synchronize(device)

    def finish(x):
        if isinstance(x, Mapping):
            return {k: finish(v) for k, v in x.items()}
        return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return finish(staged)


def span_stats(per_round_seconds) -> dict:
    """p50/p95 (in µs) over per-round wall-time samples."""
    a = np.asarray(list(per_round_seconds), np.float64)
    if a.size == 0:
        return {}
    return {"p50_us": float(np.percentile(a, 50) * 1e6),
            "p95_us": float(np.percentile(a, 95) * 1e6)}


class ShardWriter:
    """Append-only JSONL shard writer for one run directory.

    ``write_chunk(t0, hist)`` takes a chunk's stacked history (dict of
    (n,) host arrays; pair with ``host_fetch``) and writes one metrics
    shard; ``write_span``/``write_event`` append to ``events.jsonl``;
    ``summary()`` returns the running aggregates."""

    def __init__(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.rounds = 0
        self.recoveries = 0
        self._shard = 0
        self._events_path = os.path.join(out_dir, "events.jsonl")
        self._sums: dict[str, tuple[float, int]] = {}
        self._last: dict[str, float] = {}

    def write_chunk(self, t0: int, hist: dict) -> str:
        keys = sorted(hist)
        if not keys:
            return ""
        n = int(np.asarray(hist[keys[0]]).shape[0])
        path = os.path.join(self.out_dir, f"metrics-{self._shard:05d}.jsonl")
        cols = {k: np.asarray(hist[k], np.float64) for k in keys}
        with open(path, "w") as f:
            for i in range(n):
                row = {"kind": "metrics", "t": int(t0) + i}
                for k in keys:
                    row[k] = float(cols[k][i])
                f.write(json.dumps(row) + "\n")
        self._shard += 1
        self.rounds += n
        for k in keys:
            tot, cnt = self._sums.get(k, (0.0, 0))
            self._sums[k] = (tot + float(np.nansum(cols[k])),
                             cnt + int(cols[k].size))
            self._last[k] = float(cols[k][-1])
        return path

    def write_span(self, t0: int, t1: int, seconds: float,
                   compile: bool = False) -> None:
        self.write_event("span", t0=int(t0), t1=int(t1),
                         seconds=float(seconds), compile=bool(compile))

    def write_event(self, kind: str, **fields) -> None:
        if kind == "recovery":
            self.recoveries += 1
        with open(self._events_path, "a") as f:
            f.write(json.dumps({"kind": kind, **fields}) + "\n")

    def mean(self, key: str):
        tot, cnt = self._sums.get(key, (0.0, 0))
        return tot / cnt if cnt else None

    def total(self, key: str):
        return self._sums.get(key, (None, 0))[0]

    def last(self, key: str):
        return self._last.get(key)

    def summary(self) -> dict:
        return {"rounds": self.rounds,
                "shards": self._shard,
                "final_loss": self.last("loss"),
                "mean_residual": self.mean("residual"),
                "total_rejected": self.total("n_rejected"),
                "recoveries": self.recoveries}


def format_summary(s: dict) -> str:
    """The compact end-of-run line ``launch/train_lm.py`` prints."""
    parts = [f"rounds={s.get('rounds', 0)}"]
    if s.get("final_loss") is not None:
        parts.append(f"final_loss={s['final_loss']:.4f}")
    if s.get("mean_residual") is not None:
        parts.append(f"mean_residual={s['mean_residual']:.4f}")
    rej = s.get("total_rejected")
    parts.append(f"rejected={0.0 if rej is None else rej:.0f}")
    parts.append(f"retries={s.get('recoveries', 0)}")
    return "telemetry: " + "  ".join(parts)
