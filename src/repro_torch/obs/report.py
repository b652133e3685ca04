"""The report of a telemetry run directory.

Counterpart of ``repro/obs/report.py``.  ``render(run_dir)`` reads the
manifest, the metric shards and the event log that ``obs.shards`` and
``obs.manifest`` wrote and returns a text report:

1. the manifest (stack versions, backend, sketch, guard pins);
2. the metrics (rounds, and each key's final, mean and max; a round
   re-emitted by a supervised retry counts last-wins);
3. the wall-time spans per chunk, the first chunk of each length
   (``compile+run``: in the port, the kernels' first build and launch)
   apart from the steady ones (p50/p95 per round), and the recovery
   events;
4. with ``profile=True``, a profile of a 4-round bench-scale SAFL chunk
   run on the local device under ``torch.profiler``: its wall time and
   the time by kernel name (on a CPU, the host's time by operator, which
   is no device time).  The reference's XLA roofline and HLO-cost terms
   have no counterpart here.

    python -m repro_torch.obs.report RUN_DIR [--no-profile]
"""

from __future__ import annotations

import glob
import json
import os
import sys

import numpy as np

from repro_torch.obs.shards import span_stats


def load_run(run_dir: str) -> dict:
    """``{"manifest": dict, "rows": [dict], "events": [dict]}`` of a run
    directory (a missing piece comes back empty)."""
    manifest = {}
    mpath = os.path.join(run_dir, "manifest.json")
    if os.path.exists(mpath):
        with open(mpath) as f:
            manifest = json.load(f)
    rows = []
    for path in sorted(glob.glob(os.path.join(run_dir, "metrics-*.jsonl"))):
        with open(path) as f:
            for line in f:
                if line.strip():
                    rows.append(json.loads(line))
    events = []
    epath = os.path.join(run_dir, "events.jsonl")
    if os.path.exists(epath):
        with open(epath) as f:
            for line in f:
                if line.strip():
                    events.append(json.loads(line))
    return {"manifest": manifest, "rows": rows, "events": events}


def _manifest_lines(man: dict) -> list[str]:
    if not man:
        return ["  (no manifest.json)"]
    lines = [f"  run={man.get('run', '?')}  torch={man.get('torch', '?')}"
             f"  cuda={man.get('cuda', '?')}"
             f"  backend={man.get('backend', '?')}"
             f"  devices={man.get('device_count', '?')}"
             f"  device={man.get('device_name', '?')}"]
    if "mesh" in man:
        axes = "x".join(f"{k}={v}" for k, v in man["mesh"].items())
        lines.append(f"  mesh: {axes}  topology={man.get('topology', '-')}")
    if "sketch" in man:
        sk = man["sketch"]
        lines.append(f"  sketch: kind={sk.get('kind', '?')}"
                     f" ratio={sk.get('ratio', '?')}")
    if "guard_pins" in man:
        lines.append(f"  guard pins embedded: {len(man['guard_pins'])}")
    return lines


def _metric_lines(rows: list[dict]) -> list[str]:
    if not rows:
        return ["  (no metric shards)"]
    # last-wins over t: a supervised run re-emits retried spans
    by_t = {r["t"]: r for r in rows if r.get("kind") == "metrics"}
    ts = sorted(by_t)
    lines = [f"  rounds: {len(ts)} (t {ts[0]}..{ts[-1]};"
             f" {len(rows)} shard rows)"]
    keys = sorted({k for r in by_t.values() for k in r} - {"kind", "t"})
    for k in keys:
        vals = np.asarray([by_t[t][k] for t in ts if k in by_t[t]],
                          np.float64)
        if vals.size == 0:
            continue
        lines.append(f"  {k:12s} final={vals[-1]:12.6g}"
                     f"  mean={np.nanmean(vals):12.6g}"
                     f"  max={np.nanmax(vals):12.6g}")
    return lines


def _span_lines(events: list[dict]) -> list[str]:
    spans = [e for e in events if e.get("kind") == "span"]
    if not spans:
        return ["  (no spans recorded)"]
    lines = []
    steady_per_round = []
    for s in spans:
        n = max(1, int(s["t1"]) - int(s["t0"]))
        per_round = s["seconds"] / n
        tag = "compile+run" if s.get("compile") else "steady"
        lines.append(f"  rounds {s['t0']:>5}..{s['t1']:<5}"
                     f" {s['seconds']*1e3:10.1f}ms"
                     f"  {per_round*1e6:10.0f}us/round  [{tag}]")
        if not s.get("compile"):
            steady_per_round.append(per_round)
    st = span_stats(steady_per_round)
    if st:
        lines.append(f"  steady-state per-round: p50={st['p50_us']:.0f}us"
                     f"  p95={st['p95_us']:.0f}us"
                     f"  ({len(steady_per_round)} chunks)")
    for r in (e for e in events if e.get("kind") == "recovery"):
        lines.append(f"  recovery: retry {r.get('retry')}"
                     f" fault<{r.get('t_fault')}"
                     f" resume@{r.get('t_resume')}"
                     f" depth={r.get('depth')} ({r.get('reason', '')})")
    return lines


def _profile_lines(top: int = 8) -> list[str]:
    """Run a 4-round bench-scale SAFL chunk on the local device (the card
    when there is one) under ``torch.profiler``: its wall time and the
    ``top`` kernels by device time (on a CPU: operators by host time)."""
    import functools
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import prng
    from repro_torch.core.adaptive import AdaConfig, opt_state_bytes
    from repro_torch.core.packed import make_packing_plan
    from repro_torch.core.safl import SAFLConfig, init_safl, safl_round
    from repro_torch.core.sketch import SketchConfig
    from repro_torch.data.synthetic import BigramLMData, LMDataConfig
    from repro_torch.launch.driver import run_scan
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.model import (count_params_analytic, init_params,
                                          loss_fn)

    cuda = torch.cuda.is_available()
    device = "cuda" if cuda else "cpu"
    model = ModelConfig(name="obs-profile", arch_type="dense", num_layers=2,
                        d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                        vocab_size=128)
    clients, k, seq, bpc, rounds = 5, 2, 32, 10, 4
    cfg = SAFLConfig(sketch=SketchConfig(kind="countsketch", ratio=0.05,
                                         min_b=8),
                     server=AdaConfig(name="amsgrad", lr=0.01),
                     client_lr=0.5, local_steps=k)
    data = BigramLMData(LMDataConfig(vocab_size=model.vocab_size,
                                     seq_len=seq, num_clients=clients))
    sampler = data.device_sampler(bpc, k)
    params = init_params(model, torch.Generator().manual_seed(0), device)
    round_fn = functools.partial(safl_round, cfg,
                                 lambda p, b: loss_fn(model, p, b),
                                 plan=make_packing_plan(cfg.sketch, params))

    def chunk():
        run_scan(round_fn, sampler, params, init_safl(cfg, params),
                 rounds=rounds, key=prng.key(0))
        if cuda:
            torch.cuda.synchronize()

    chunk()                                   # warm-up
    # the card's activity alone on the card: with the host's too, each
    # kernel's time would also count under the operator that launched it
    acts = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        chunk()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if cuda:
            t = (getattr(e, "self_device_time_total", None)
                 or getattr(e, "self_cuda_time_total", 0.0))
        else:
            t = e.self_cpu_time_total
        if t > 0:
            name = e.key.replace("void ", "").replace("at::native::", "")
            rows.append((t / 1e3, e.count, name[:100]))
    busy = sum(t for t, _, _ in rows)
    n_active = count_params_analytic(model, active_only=True)
    what = (f"device {torch.cuda.get_device_name(0)}" if cuda else
            "CPU: host operator time, not a device time")
    lines = [
        f"  program: {rounds}-round SAFL chunk, bench model"
        f" ({n_active / 1e3:.0f}k params, server state"
        f" {opt_state_bytes(cfg.server, params) / 1e3:.0f} kB, sketch ratio"
        f" {cfg.sketch.ratio}) on {device}",
        f"  wall {wall_ms:.1f} ms under the profiler; {what}:"
        f" {busy:.1f} ms in {sum(c for _, c, _ in rows)} calls",
    ]
    for t, c, name in sorted(rows, reverse=True)[:top]:
        lines.append(f"  {t:10.3f} ms  {c:6d}x  {name}")
    return lines


def render(run_dir: str, profile: bool = True) -> str:
    run = load_run(run_dir)
    out = [f"== telemetry run report: {run_dir} ==", "", "-- manifest --"]
    out += _manifest_lines(run["manifest"])
    out += ["", "-- metrics --"]
    out += _metric_lines(run["rows"])
    out += ["", "-- wall-time spans --"]
    out += _span_lines(run["events"])
    if profile:
        out += ["", "-- profile (torch.profiler, local device) --"]
        try:
            out += _profile_lines()
        except Exception as e:  # the report stays usable without it
            out.append(f"  profile section unavailable: {e!r}")
    return "\n".join(out) + "\n"


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    profile = "--no-profile" not in argv
    paths = [a for a in argv if not a.startswith("--")]
    if len(paths) != 1:
        print(__doc__)
        return 2
    if not os.path.isdir(paths[0]):
        print(f"# not a run directory: {paths[0]}")
        return 2
    sys.stdout.write(render(paths[0], profile=profile))
    return 0


if __name__ == "__main__":
    sys.exit(main())
