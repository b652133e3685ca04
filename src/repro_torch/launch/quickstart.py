"""Quickstart: SAFL on a tiny LM, through the port's round driver.

The port's counterpart of ``examples/quickstart.py``: the same model,
sketch, server, data and 60 rounds, run through ``run_scan`` in chunks of
10 rounds (the losses come to the host once per chunk), printed the same
way.  The weights are the port's own random init (seed 0).

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse
import functools

import torch

from repro_torch import prng
from repro_torch.core.adaptive import AdaConfig
from repro_torch.core.packed import make_packing_plan
from repro_torch.core.safl import (SAFLConfig, init_safl, safl_round,
                                   uplink_bits_per_round)
from repro_torch.core.sketch import SketchConfig
from repro_torch.data.synthetic import BigramLMData, LMDataConfig
from repro_torch.launch.driver import run_scan
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_params, loss_fn

MODEL = ModelConfig(name="tiny", arch_type="dense", num_layers=2, d_model=64,
                    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128)
SAFL = SAFLConfig(
    sketch=SketchConfig(kind="countsketch", ratio=0.05, min_b=16),
    server=AdaConfig(name="amsgrad", lr=0.01),       # Algorithm 2
    client_lr=0.5, local_steps=2)                    # K = 2 local SGD steps


ROUNDS, CHUNK = 60, 10


def run(device: str = "cuda"):
    """Train ``ROUNDS`` rounds on ``device``; returns (params, opt, history)."""
    params = init_params(MODEL, torch.Generator().manual_seed(0), device)
    opt = init_safl(SAFL, params)
    d = sum(p.numel() for p in params.values())
    bits = uplink_bits_per_round(SAFL, params)
    print(f"model: d = {d:,} parameters")
    print(f"uplink per round: {bits / 8 / 1024:.1f} KiB  (dense would be "
          f"{d * 4 / 1024:.1f} KiB -> {d * 32 / bits:.0f}x compression)")

    data = BigramLMData(LMDataConfig(vocab_size=128, seq_len=32,
                                     num_clients=5, alpha=0.03))
    sampler = data.device_sampler(batch_per_client=8, local_steps=2)
    # static sketch layout once; the round operator re-derives per round key
    plan = make_packing_plan(SAFL.sketch, params)
    round_fn = functools.partial(safl_round, SAFL,
                                 lambda p, b: loss_fn(MODEL, p, b), plan=plan)
    params, opt, hist = run_scan(
        round_fn, sampler, params, opt, rounds=ROUNDS, key=prng.key(0),
        chunk_size=CHUNK, bits_per_round=bits,
        on_chunk=lambda t, p, s, h: print(
            f"round {t - 1:3d}  mean client loss = {h['loss'][-1]:.4f}"))
    print(f"done: loss {hist['loss'][0]:.4f} -> {hist['loss'][-1]:.4f} with a "
          f"{d * 32 / bits:.0f}x-compressed uplink, "
          f"{int(hist['uplink_bits'].sum() / 8 / 1024)} KiB total uplink, "
          f"{ROUNDS // CHUNK} metric fetches for {ROUNDS} rounds on {device}.")
    return params, opt, hist


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; cpu runs the kernels' "
                         "plain versions)")
    run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
