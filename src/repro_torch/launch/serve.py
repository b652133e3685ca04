"""Batched greedy serving over the cached decode path.

The port's counterpart of ``repro/launch/serve.py``: loads a named
architecture (``--smoke``, the default, shrinks it to the reference's SMOKE
size; ``--no-smoke`` serves the published config), allocates its cache
(ring-buffered for a sliding window), runs the audio encoder once for an
encoder-decoder config (``encode_for_decode`` fills the cross-attention
cache), then greedy-decodes ``--batch`` sequences for ``--steps`` tokens
through ``decode_step`` and reports tokens/s.  ``example()`` is the port
of ``examples/serve.py``: the same small sliding-window model, inline.

The reference decodes the whole batch at one scalar position and has no
prefill, so requests share one prompt length: ``run`` feeds the prompt one
token at a time through ``decode_step`` (the reference's prompt is one 0
token), then decodes greedily.  The position, the tokens and the argmax
stay on the device, so the loop never waits for the host.  The weights
are the port's own random init unless the caller passes some.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b [--no-smoke] [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch import prng
from repro_torch.configs import get_config
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (decode_step, encode_for_decode,
                                      init_cache, init_params)

# examples/serve.py's model and run
EXAMPLE = ModelConfig(name="serve", arch_type="dense", num_layers=4,
                      d_model=256, num_heads=8, num_kv_heads=4, d_ff=512,
                      vocab_size=1024, sliding_window=64)
EXAMPLE_BATCH, EXAMPLE_STEPS, EXAMPLE_MAX_SEQ = 8, 48, 64


def run(cfg: ModelConfig, *, batch: int = 4, steps: int = 32,
        max_seq: int = 64, prompt: Optional[torch.Tensor] = None,
        params: Optional[dict] = None, audio: Optional[torch.Tensor] = None,
        device="cuda", keep_logits: bool = False) -> dict:
    """Serve ``batch`` requests: feed ``prompt`` (batch, P) (default: one 0
    token each, as the reference), then ``steps`` greedy tokens.  Without
    ``params``, ``init_params`` draws them from a generator seeded 0 on
    ``device``; without ``audio``, an encoder-decoder config encodes
    0.02-scaled normals of key 1 (the reference draws its own in
    ``cfg.dtype``).

    Returns ``tokens`` (batch, P + steps) (the prompt, then the greedy
    tokens), the last call's ``logits`` (batch, vocab_size), every call's
    as ``all_logits`` (calls, batch, vocab_size) if ``keep_logits``,
    ``step_ms`` (each of the P - 1 + steps calls: CUDA events on a card,
    the host clock on the CPU), ``tokens_per_s`` over the calls that
    generate, ``seconds`` (the loop's wall time, ending in a synchronise),
    ``cache`` and ``cache_bytes``."""
    dev = torch.device(device)
    if params is None:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    if prompt is None:
        prompt = torch.zeros((batch, 1), dtype=torch.int64, device=dev)
    P = prompt.shape[1]
    calls = P - 1 + steps
    cache = init_cache(cfg, batch, max_seq, dev)
    if cfg.encoder_layers:
        if audio is None:
            audio = (prng.normal(prng.key(1), (batch, cfg.encoder_seq, cfg.d_model),
                                 dev) * 0.02).to(cfg.dtype)
        cache = encode_for_decode(cfg, params, cache, audio)
    seq = torch.zeros((batch, P + steps), dtype=torch.int64, device=dev)
    seq[:, :P] = prompt
    positions = torch.arange(calls, device=dev)
    kept = []
    cuda = dev.type == "cuda"
    marks = []

    def mark():
        if cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        else:
            marks.append(time.perf_counter())

    if cuda:
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for t in range(calls):
        mark()
        logits, cache = decode_step(cfg, params, cache, seq[:, t:t + 1], positions[t])
        if t >= P - 1:
            seq[:, t + 1] = torch.argmax(logits, dim=-1)
        if keep_logits:
            kept.append(logits)
    mark()
    if cuda:
        torch.cuda.synchronize(dev)
        step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    seconds = time.perf_counter() - t0
    out = {"tokens": seq, "logits": logits, "step_ms": step_ms, "seconds": seconds,
           "tokens_per_s": batch * steps / (sum(step_ms[P - 1:]) / 1e3),
           "cache": cache,
           "cache_bytes": sum(c.numel() * c.element_size() for c in cache.values())}
    if keep_logits:
        out["all_logits"] = torch.stack(kept)
    return out


def device_name(device) -> str:
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"


def example(device="cuda", params: Optional[dict] = None,
            keep_logits: bool = False) -> dict:
    """``examples/serve.py`` on the port: 8 sequences from a random first
    token (key 1), 48 greedy steps through a 4-layer sliding-window model's
    ring cache of 64 slots.  Prints tokens/s and the head of the first
    sequence; returns ``run``'s result."""
    prompt = prng.randint(prng.key(1), (EXAMPLE_BATCH, 1), 0, EXAMPLE.vocab_size,
                          device)
    out = run(EXAMPLE, batch=EXAMPLE_BATCH, steps=EXAMPLE_STEPS,
              max_seq=EXAMPLE_MAX_SEQ, prompt=prompt, params=params, device=device,
              keep_logits=keep_logits)
    print(f"decoded {EXAMPLE_BATCH} x {EXAMPLE_STEPS} tokens in {out['seconds']:.2f}s "
          f"({out['tokens_per_s']:.0f} tok/s on {device_name(device)}, "
          f"ring-buffered SWA cache)")
    print("first sequence:", out["tokens"][0, :16].tolist(), "...")
    if not bool(torch.isfinite(out["logits"]).all()):
        raise FloatingPointError("serve example: logits not finite")
    return out


def parser() -> argparse.ArgumentParser:
    """The reference's flags, with ``--smoke`` switchable (``--no-smoke``;
    the reference's ``store_true`` with default True cannot be turned off)
    and ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction, default=True,
                    help="the SMOKE config (default); --no-smoke serves the "
                         "published one")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    cfg = get_config(args.arch, smoke=args.smoke)
    out = run(cfg, batch=args.batch, steps=args.steps, max_seq=args.max_seq,
              device=args.device)
    print(f"{cfg.name}: {args.batch}x{args.steps} tokens in {out['seconds']:.2f}s "
          f"({out['tokens_per_s']:.0f} tok/s, {device_name(args.device)})")
    return out


if __name__ == "__main__":
    main()
