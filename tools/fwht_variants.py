"""Time variants of B2's long-row kernel against the kept one, on one card.

    python3 tools/fwht_variants.py

Needs one CUDA card and nvcc.  Each variant is ``csrc/fwht.cu`` with a few
lines replaced (the replacements below), built with the port's nvcc flags
into ``build/fwht_variants/`` and called through its C entry point
``fwht_long``.  At the long (R, C) groups of one lm25m SRHT round it prints
each variant's time by CUDA events, the L2 cache flushed before each call,
in alternating order (kept, a, b, ..., b, a, kept, twice), and whether its
result equals the plain version bit for bit ("pass one alone" and "pass two
alone" skip half the work, so theirs does not).  One more variant is the
kept kernel called with a chunk of all R rows (``chunk_rows`` gives one
row of 2^22): both passes over all rows in turn, pass two reading device
memory.  This is how the kept
design's choices were measured; a source whose lines moved on fails with
the line it did not find.
"""

import ctypes
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import fwht as fw  # noqa: E402

# (R, C) of the round's calls with C > 4096 (tools/fwht_profile.py ROUND)
LONG = ((20, 1 << 20), (4, 1 << 20), (10, 1 << 21), (2, 1 << 21), (15, 1 << 22),
        (3, 1 << 22))
BOUNDS = "__launch_bounds__(FWHT_THREADS, 3)"
COL_PASS = ("      col_pass<L1, LOG_C1>(out, (r << LOG_N) + (o % P2T) * "
            "ColPass<L1>::TC, smem);")
ROW_PASS = ("      row_pass<LOG_C1>(in, out, e0, (r + 1) << LOG_N, "
            "reinterpret_cast<float*>(smem));")
RESULT_STORE = ("      __stcs(reinterpret_cast<float4*>(col + ((long long)row << LOG_C1)), "
                "v[k]);")
VARIANTS = {
    "kept": [],
    "two blocks an SM": [(BOUNDS, "__launch_bounds__(FWHT_THREADS, 2)")],
    "8 float4s a thread, four blocks an SM": [
        ("#define FWHT_COL_VECS 16", "#define FWHT_COL_VECS 8"),
        ("cmin(ilog2c(FWHT_COL_VECS), L1);",
         "cmax(ilog2c(FWHT_COL_VECS), L1 - ilog2c(FWHT_THREADS));"),
        (BOUNDS, "__launch_bounds__(FWHT_THREADS, 4)")],
    "result stored without the evict-first hint": [
        (RESULT_STORE, "      *reinterpret_cast<float4*>(col + ((long long)row << LOG_C1)) "
                       "= v[k];")],
    "pass one alone": [(COL_PASS, "")],
    "pass two alone (its input from device memory)": [(ROW_PASS, "")],
}
ALL_ROWS = "kept, chunk = R (both passes over all rows in turn)"


def build_variants() -> dict[str, ctypes.CDLL]:
    src = (build.CSRC / "fwht.cu").read_text()
    out = build.BUILD_ROOT.parent / "fwht_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"fwht_variants: {name}: line not found: {old!r}")
            text = text.replace(old, new)
        cu, lib = out / f"v{i}.cu", out / f"libv{i}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"fwht_variants: {name}: nvcc failed\n{log}")
        regs = sorted({line.split("Used ")[1].split(" registers")[0]
                       for line in log.splitlines() if "registers" in line})
        spills = sorted({line.strip() for line in log.splitlines()
                         if "spill stores" in line and not line.strip().startswith("0 bytes")})
        print(f"{name}: registers {regs}; spills {spills or 'none'}")
        libs[name] = ctypes.CDLL(os.path.abspath(lib))
    return libs


def call(lib: ctypes.CDLL, x: torch.Tensor, out: torch.Tensor, work: torch.Tensor,
         chunk: int = 0) -> None:
    n1, c1 = fw.split(x.shape[1])
    fn = lib.fwht_long
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, ctypes.c_longlong, i, i, i, vp, vp, ctypes.POINTER(i)]
    launched = ctypes.c_int(0)
    err = fn(x.data_ptr(), out.data_ptr(), x.shape[0], n1.bit_length() - 1,
             c1.bit_length() - 1, chunk or fw.chunk_rows(x.shape[1]), work.data_ptr(),
             torch.cuda.current_stream().cuda_stream, ctypes.byref(launched))
    if err:
        raise SystemExit(f"fwht_variants: launch failed: CUDA error {err}")


def main() -> int:
    if not torch.cuda.is_available():
        print("fwht_variants: no CUDA device", file=sys.stderr)
        return 2
    libs = build_variants()
    libs[ALL_ROWS] = libs["kept"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    xs = [torch.randn(s, generator=gen, device="cuda") for s in LONG]
    outs = [torch.empty_like(x) for x in xs]
    works = [torch.empty(s[0] + 1, dtype=torch.int32, device="cuda") for s in LONG]
    flush = torch.empty(64 << 20, device="cuda")   # 256 MB, over the 50 MB L2
    names = list(libs)
    times: dict[tuple[str, int], list[float]] = {}
    for name in (names + names[::-1]) * 2:
        for j, (x, out, work) in enumerate(zip(xs, outs, works)):
            chunk = x.shape[0] if name == ALL_ROWS else 0
            call(libs[name], x, out, work, chunk)
            flush.zero_()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            call(libs[name], x, out, work, chunk)
            b.record()
            torch.cuda.synchronize()
            times.setdefault((name, j), []).append(a.elapsed_time(b))
    for name in names:
        exact = []
        for x, out, work in zip(xs, outs, works):
            out.fill_(float("nan"))
            call(libs[name], x, out, work, x.shape[0] if name == ALL_ROWS else 0)
            exact.append(torch.equal(out, fw.fwht_plain(x)))
        per = [sum(times[name, j]) / len(times[name, j]) for j in range(len(LONG))]
        print(f"{name}: " + ", ".join(f"{s} {t:.4f}" for s, t in zip(LONG, per))
              + f" ms; six long groups {sum(per):.4f} ms; bitwise equal: {all(exact)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
