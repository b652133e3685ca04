"""End-to-end training: SAFL on a ~25M-parameter LM over synthetic
federated data, with a cosine server LR, checkpoints, faults, sentinels,
the payload codec, the async buffer, telemetry and the rollback
supervisor.

The port's counterpart of ``examples/train_lm.py``: the same flags,
defaults and refusals, the same models (lm25m; ``--big`` gives lm100m),
``SAFLConfig`` and data, plus ``--device`` (default ``cuda``).  The
weights are the port's own random init (seed 0).

    PYTHONPATH=src python -m repro_torch.launch.train_lm [--rounds 200] [--big]

The rounds run through ``launch.driver.run_scan`` in chunks of 100, the
cosine LR riding in through ``kwargs_fn``.  Each chunk saves a
checkpoint with the ``(t, key)`` cursor (unless the supervisor, which
owns checkpoints when on, records its rekeyed cursor), and ``--resume``
restarts from it: every per-round stream (data, cohorts, delays, faults,
sketch operators) is a pure function of the absolute round index, so the
resumed run replays the uninterrupted one.  ``--faults RATE`` injects
dropouts, NaN payloads and Byzantine scaling at RATE/3 each,
``--sentinel`` rejects the corrupted uplinks, ``--max-retries N`` wraps
the run in the rollback supervisor, ``--telemetry`` turns on the probes
and streams JSONL shards and a manifest into ``--telemetry-out`` (render
them with ``python -m repro_torch.obs.report DIR``), ``--codec`` quantizes
the sketch uplink with error feedback, ``--participation-frac`` samples a
cohort, and ``--async-buffer D`` runs the staleness buffer.  The
count-sketch is the reference's default balanced hash, which reaches no
kernel, as in the reference.
"""

from __future__ import annotations

import argparse
import functools
import os
import tempfile

import numpy as np
import torch

from repro_torch import prng
from repro_torch.checkpoint.io import restore_checkpoint, save_checkpoint
from repro_torch.core.adaptive import AdaConfig
from repro_torch.core.packed import make_packing_plan
from repro_torch.core.safl import SAFLConfig, fedopt_round, init_safl, safl_round
from repro_torch.core.sketch import SketchConfig
from repro_torch.data.synthetic import BigramLMData, LMDataConfig
from repro_torch.fed import (AsyncConfig, CodecConfig, FaultConfig,
                             SentinelConfig, UniformParticipation,
                             init_async_state, init_codec_state,
                             make_async_round)
from repro_torch.launch.driver import run_scan
from repro_torch.launch.supervisor import (SupervisorConfig,
                                           format_recovery_log, run_supervised)
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_params, loss_fn
from repro_torch.obs import ShardWriter, Telemetry, format_summary, write_manifest
from repro_torch.optim.schedules import cosine

LM25M = ModelConfig(name="lm25m", arch_type="dense", num_layers=6,
                    d_model=384, num_heads=6, num_kv_heads=6, d_ff=1536,
                    vocab_size=4096)
LM100M = ModelConfig(name="lm100m", arch_type="dense", num_layers=12,
                     d_model=768, num_heads=12, num_kv_heads=12, d_ff=3072,
                     vocab_size=8192)
CHUNK = 100


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--big", action="store_true")
    ap.add_argument("--ratio", type=float, default=0.02)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "safl_lm"))
    ap.add_argument("--fedopt", action="store_true", help="run the "
                    "uncompressed reference instead of SAFL")
    ap.add_argument("--participation-frac", type=float, default=1.0,
                    help="fraction of clients sampled per round (uniform "
                    "without replacement; 1.0 = all)")
    ap.add_argument("--async-buffer", type=int, default=0, metavar="MAX_DELAY",
                    help="run the staleness buffer with client delays up to "
                    "MAX_DELAY rounds (0 = synchronous)")
    ap.add_argument("--faults", type=float, default=0.0, metavar="RATE",
                    help="inject deterministic client faults at this total "
                    "rate, RATE/3 each of dropout-after-compute, NaN payloads "
                    "and 1e3-scaled Byzantine payloads (0 = fault-free)")
    ap.add_argument("--sentinel", action="store_true",
                    help="enable the sketch-space payload sentinels: finite "
                    "checks and norm-outlier rejection in the aggregation mask")
    ap.add_argument("--max-retries", type=int, default=0, metavar="N",
                    help="wrap the run in the checkpoint-rollback supervisor "
                    "with up to N rekeyed retries (0 = unsupervised)")
    ap.add_argument("--telemetry", action="store_true",
                    help="enable the telemetry probes and stream per-chunk "
                    "JSONL metric shards and a run manifest")
    ap.add_argument("--telemetry-out", default=None, metavar="PATH",
                    help="run directory for the shards and manifest "
                    "(default: <--ckpt>_obs)")
    ap.add_argument("--codec", choices=["int8", "1bit"], default=None,
                    help="quantize the packed sketch uplink (stochastic "
                    "rounding, sketch-space error feedback); uplink_bits "
                    "becomes the measured encoded size")
    ap.add_argument("--resume", action="store_true",
                    help="restart from --ckpt's (t, key) cursor (pass the "
                    "same model and algorithm flags)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; cpu runs the "
                    "kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.fedopt and args.async_buffer > 0:
        ap.error("--async-buffer is SAFL-only; drop --fedopt to run the "
                 "staleness buffer")
    if args.fedopt and (args.faults > 0 or args.sentinel):
        ap.error("--faults/--sentinel act on the packed sketch uplink; the "
                 "uncompressed FedOPT reference has no sketch payload")
    if args.fedopt and args.codec:
        ap.error("--codec quantizes the packed sketch uplink; the uncompressed "
                 "FedOPT reference has no sketch payload")
    if args.codec and args.telemetry:
        ap.error("--telemetry probes read the bare server opt state; under the "
                 "codec's error feedback the round state is the wrapped "
                 "{'opt','ef'} dict -- run one or the other")
    return args


def _cursor(params, opt, t: int, key: prng.Key) -> dict:
    return {"params": params, "opt": opt,
            "cursor": {"t": np.asarray(t),
                       "key": np.asarray(key, dtype=np.uint32)}}


def main(argv=None) -> None:
    args = parse_args(argv)
    model = LM100M if args.big else LM25M
    safl = SAFLConfig(
        sketch=SketchConfig(kind="countsketch", ratio=args.ratio, min_b=64),
        server=AdaConfig(name="amsgrad", lr=0.01),
        client_lr=0.5, local_steps=2)
    data = BigramLMData(LMDataConfig(vocab_size=model.vocab_size, seq_len=64,
                                     num_clients=5, heterogeneity=0.3,
                                     alpha=0.02))
    params = init_params(model, torch.Generator().manual_seed(0), args.device)
    opt = init_safl(safl, params)
    loss = lambda p, b: loss_fn(model, p, b)
    sampler = data.device_sampler(batch_per_client=8, local_steps=2)
    sched = cosine(args.rounds, warmup=10)

    sentinel = SentinelConfig(norm_mult=10.0) if args.sentinel else None
    codec = None
    if args.codec:
        codec = CodecConfig(bits=8 if args.codec == "int8" else 1)
    plan = make_packing_plan(safl.sketch, params)
    async_cfg = None
    if args.fedopt:
        round_fn = functools.partial(fedopt_round, safl, loss)
    elif args.async_buffer > 0:
        async_cfg = AsyncConfig(max_delay=args.async_buffer, delay="uniform")
        round_fn = make_async_round(safl, loss, async_cfg, plan, codec=codec)
        opt = init_async_state(safl, async_cfg, params, plan,
                               data.cfg.num_clients, codec=codec)
    else:
        round_fn = functools.partial(safl_round, safl, loss, plan=plan)
        if codec is not None:
            # the EF memory rides in the state, so the driver carries it
            # and --resume round-trips it
            round_fn = functools.partial(round_fn, codec=codec)
            if codec.error_feedback:
                opt = {"opt": opt,
                       "ef": init_codec_state(codec, data.cfg.num_clients,
                                              plan.b_total, args.device)}
    if sentinel is not None:
        round_fn = functools.partial(round_fn, sentinel=sentinel)

    stream = None
    if args.telemetry:
        if args.async_buffer == 0:
            # the async round owns its multi-generation aggregation and takes
            # no probe config; its counters still stream
            round_fn = functools.partial(round_fn, telemetry=Telemetry())
        obs_dir = args.telemetry_out or (args.ckpt + "_obs")
        stream = ShardWriter(obs_dir)
        write_manifest(obs_dir, run="train_lm", sketch=safl.sketch,
                       config=dict(vars(args)))
        print("telemetry: streaming metric shards to", obs_dir)

    faults = None
    if args.faults > 0:
        r = args.faults / 3.0
        faults = FaultConfig(num_clients=data.cfg.num_clients, drop_rate=r,
                             nan_rate=r, byzantine_rate=r)
        print(f"fault injection: total rate {args.faults} "
              f"(drop/NaN/Byzantine {r:.3f} each)"
              + ("" if args.sentinel else " -- UNGUARDED, pass --sentinel"))

    participation = None
    if args.participation_frac < 1.0:
        participation = UniformParticipation(data.cfg.num_clients,
                                             frac=args.participation_frac)
        print(f"partial participation: {participation.cohort_size}"
              f"/{data.cfg.num_clients} clients per round")
    if async_cfg is not None:
        print(f"async staleness buffer: max delay {async_cfg.max_delay} rounds")
    if codec is not None:
        print(f"payload codec: {args.codec} "
              f"({codec.payload_bits(plan.b_total)} measured bits/client/round "
              f"vs {32 * plan.b_total} float32)")

    n = sum(p.numel() for p in params.values())
    print(f"{'FedOPT' if args.fedopt else 'SAFL'} on {n/1e6:.1f}M params, "
          f"sketch ratio {args.ratio}, device {args.device}")

    key = prng.key(0)
    start_round = 0
    if args.resume:
        # the ``like`` tree fixes structure and dtypes, so a checkpoint from
        # other flags fails loudly here
        state, _ = restore_checkpoint(args.ckpt, {
            "params": params, "opt": opt,
            "cursor": {"t": torch.tensor(0),
                       "key": torch.zeros(2, dtype=torch.uint32)}})
        params, opt = state["params"], state["opt"]
        key = tuple(int(k) for k in state["cursor"]["key"].tolist())
        start_round = int(state["cursor"]["t"])
        print(f"resuming from {args.ckpt}.npz at round {start_round}")

    def on_chunk(t_done, p, o, hist):
        print(f"round {t_done - 1:4d}  loss {hist['loss'][-1]:.4f}")
        if args.max_retries == 0 and t_done < args.rounds:
            # the resumable (t, key) cursor; under the supervisor it saves
            # the rekeyed cursor itself
            save_checkpoint(args.ckpt, _cursor(p, o, t_done, key), step=t_done)

    run_kw = dict(chunk_size=CHUNK, kwargs_fn=lambda t: {"lr_scale": sched(t)},
                  participation=participation, buffer=async_cfg is not None,
                  faults=faults, stream=stream)
    if args.max_retries > 0:
        def launch(p, o, *, key, start_round, on_chunk):
            return run_scan(round_fn, sampler, p, o, rounds=args.rounds,
                            key=key, on_chunk=on_chunk,
                            start_round=start_round, **run_kw)

        params, opt, _, recovery = run_supervised(
            launch, params, opt, rounds=args.rounds, key=key,
            config=SupervisorConfig(max_retries=args.max_retries),
            on_chunk=on_chunk, ckpt_path=args.ckpt, start_round=start_round,
            stream=stream)
        print(format_recovery_log(recovery))
    else:
        params, opt, _ = run_scan(round_fn, sampler, params, opt,
                                  rounds=args.rounds, key=key,
                                  on_chunk=on_chunk, start_round=start_round,
                                  **run_kw)
        save_checkpoint(args.ckpt, _cursor(params, opt, args.rounds, key),
                        step=args.rounds)
    if stream is not None:
        print(format_summary(stream.summary()))
    print("checkpoint saved to", args.ckpt + ".npz")


if __name__ == "__main__":
    main()
