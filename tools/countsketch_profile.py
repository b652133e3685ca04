"""Device time of each kernel of the count-sketch route, by name, at its two
main-path shapes: the bert_100m uplink (G=5, n=132,008,448, b=2,640,275,
int32 hash) and the lm25m SRHT desk scatter (G=1, n=70,779, b=4,194,304,
int64 indices), with random inputs from a fixed seed.

    python3 tools/countsketch_profile.py

Needs one CUDA card; builds the kernels first.  Prints torch.profiler's
table of three calls at each shape and the host's time to enqueue a call.
Then, at the desk scatter's shape, the small-n route (a warp per window of
1,024 slots) against the large-n route's launches at its widest windows
(256 slots, a block per window in the reduce): device time of a call by
CUDA events, and each route's kernels.
"""

import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import countsketch as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("countsketch_profile: no CUDA device", file=sys.stderr)
        return 2
    build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for g, n, b, dtype in ((5, 132_008_448, 2_640_275, torch.int32),
                           (1, 70_779, 1 << 22, torch.int64)):
        x = torch.randn((g, n), generator=gen, device="cuda") * 1e-3
        h = torch.randint(0, b, (n,), generator=gen, device="cuda", dtype=dtype)
        for _ in range(3):
            cs.countsketch_clients_cuda(x, h, b)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                cs.countsketch_clients_cuda(x, h, b)
            torch.cuda.synchronize()
        print(f"== G={g} n={n} b={b}, route {cs.route(n, b)} (3 calls)")
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=12,
                                        max_name_column_width=40))
        t0 = time.perf_counter()
        for _ in range(200):
            cs.countsketch_clients_cuda(x, h, b)
        host = (time.perf_counter() - t0) / 200
        torch.cuda.synchronize()
        print(f"host time to enqueue one call: {host * 1e6:.1f} us")
        del x, h
        torch.cuda.empty_cache()

    g, n, b = 1, 70_779, 1 << 22
    x = torch.randn((g, n), generator=gen, device="cuda")
    h = torch.randint(0, b, (n,), generator=gen, device="cuda")
    want = cs.countsketch_clients_ordered(x, h, b)
    out = torch.empty((g, b), device="cuda")
    for name, fn in (
            (f"small-n route, {cs.route(n, b)[0]} slots a window (warp per window)",
             lambda: cs.small_route(x, h, b, cs.route(n, b)[0], out)),
            (f"large-n route, {cs.BIG_SLOTS} slots a window (block per window)",
             lambda: cs.large_route(x, h, b, cs.BIG_SLOTS, out))):
        fn()
        same = torch.equal(out, want)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(50):
            fn()
        end.record()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        print(f"== G={g} n={n} b={b}, {name}: {start.elapsed_time(end) / 50:.4f} ms "
              f"a call (CUDA events, 50 calls); equal to the ordered sum: {same}")
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=8,
                                        max_name_column_width=40))
    return 0


if __name__ == "__main__":
    sys.exit(main())
