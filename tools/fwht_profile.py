"""Device time of the FWHT route's kernels, by name, at the (R, C) groups of
one lm25m SRHT round (ratio 0.02, min_b 64, 5 clients: sk on (5 L, n2),
desk on (L, n2) for each padded length n2), plus the first pass of the
largest group alone, with random inputs from a fixed seed.

    python3 tools/fwht_profile.py [--root DIR]

Needs one CUDA card; builds the kernels first.  ``--root`` profiles the
``repro_torch`` of another checkout (an unpacked parent commit, say), which
needs only ``kernels.fwht.fwht_rows_cuda`` and ``kernels.build``.  For each
shape it prints torch.profiler's device time per call of each kernel (over
5 warm calls), the time of a call by CUDA events with the 50 MB L2 cache
flushed before it (cold) and back to back (warm), the least time the card
could take (each element read and written once at 3.35 TB/s), and the
host's time to enqueue a call.
"""

import argparse
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

HBM_BYTES_PER_S = 3.35e12
# (R, C) of the FWHT calls of one lm25m SRHT round: (sk, desk) per group
ROUND = ((5, 512), (1, 512), (10, 4096), (2, 4096), (20, 1 << 20), (4, 1 << 20),
         (10, 1 << 21), (2, 1 << 21), (15, 1 << 22), (3, 1 << 22))
FIRST_PASS = (15 * 1024, 4096)   # the largest group's rows of 4096 alone


def timed(fn, iters: int, flush: torch.Tensor | None) -> float:
    """Mean ms of fn() by CUDA events, flush.zero_() before each call when
    given (the events bracket the call alone)."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def kernel_us(fn, calls: int = 5) -> dict[str, float]:
    """Device microseconds per call of each kernel fn launches (profiler)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
        if t > 0 and ("fwht" in e.key or "emset" in e.key):
            out[e.key.split("(")[0][:48]] = t / calls
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fwht_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import fwht as fw
    print(f"fwht_profile: kernels of {fw.__file__}")
    build.build_all()
    flush = torch.empty(64 << 20, device="cuda")   # 256 MB, over the 50 MB L2
    gen = torch.Generator(device="cuda").manual_seed(0)
    sums = {"cold": 0.0, "warm": 0.0, "bound": 0.0}
    for shape in ROUND + (FIRST_PASS,):
        x = torch.randn(shape, generator=gen, device="cuda")
        fn = lambda: fw.fwht_rows_cuda(x)    # noqa: E731
        cold, warm = timed(fn, 10, flush), timed(fn, 10, None)
        bound = 2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3
        t0 = time.perf_counter()
        for _ in range(50):
            fn()
        host = (time.perf_counter() - t0) / 50
        torch.cuda.synchronize()
        per = ", ".join(f"{k} {v:.1f}" for k, v in kernel_us(fn).items())
        print(f"{shape}: cold {cold:.4f} ms, warm {warm:.4f} ms, bound {bound:.4f} ms; "
              f"host enqueue {host * 1e6:.1f} us; device us per call: {per}")
        if shape != FIRST_PASS:
            sums["cold"] += cold
            sums["warm"] += warm
            sums["bound"] += bound
        del x
    print(f"one round's ten calls: cold {sums['cold']:.4f} ms, warm {sums['warm']:.4f} ms, "
          f"bound {sums['bound']:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
