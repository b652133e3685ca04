"""Profile the Gaussian pair, B3 (sk) and B4 (desk), on one card.

    python3 tools/gauss_profile.py [--root DIR] [--variants] [--sass FILE]

Needs one CUDA card and the CUDA toolkit (``nvcc``, ``cuobjdump``); exits
nonzero without a card.  ``--root`` profiles the ``repro_torch`` of another
checkout (an unpacked parent commit, say), which needs only
``kernels.gaussian_sketch`` and ``kernels.build``.  It prints:

* each kernel's registers and spills (``cuobjdump -res-usage``);
* for each kernel, the SASS of its inner loop (the innermost loop that
  holds the most splitmix32 multiplies by 0x85EBCA6B, two per element of
  R): each opcode's count per element and the pipe it issues to, and the
  sum per pipe.  The counts are static: a branch out of the loop (a slow
  path) counts as if taken once per iteration;
* at the lm25m plan's attention leaf (884,736 x 17,695) and its largest
  leaf (3,538,944 x 70,779): each call's time by CUDA events, the device
  time per call of each kernel by name (torch.profiler), and the bound's
  terms (chip_smoke.gauss_bound_terms of this checkout); at the attention
  leaf also the SM clock and power draw that nvidia-smi reads meanwhile;
* the error of R itself: desk with b = 1 and s = [1] returns R's first
  column, 2**24 elements (u1, u2 drawn over their whole range), against
  the plain version on the card.

``--variants`` also builds ``csrc/gaussian_sketch.cu`` of this checkout
with the lines of ``VARIANTS`` replaced (into ``build/gauss_variants/``),
and times each variant's sk and desk at the attention leaf against the
kept kernel, in alternating order, with each one's largest difference from
the kept kernel's output.  ``--sass FILE`` writes the whole disassembly.
"""

import argparse
import collections
import ctypes
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

HERE = Path(__file__).resolve().parents[1]
ATT = (884_736, 17_695)        # (n, b) of an lm25m attention leaf, ratio 0.02
BIG = (3_538_944, 70_779)      # an lm25m MLP leaf, the plan's largest
SEED = 0x2545F491

# the pipe of each SASS opcode on Hopper: the integer ALU (64 lanes an SM),
# the FMA-heavy pipe (integer multiplies, and float32), float32 on either
# FMA pipe (128 lanes together), the 16-lane pipe of special functions and
# conversions, memory, the uniform datapath, and branches and barriers
PIPE = {
    "alu": ("IADD3", "LOP3", "SHF", "PRMT", "LEA", "ISETP", "FSETP", "SEL",
            "FSEL", "MOV", "IMNMX", "FMNMX", "PLOP3", "P2R", "R2P", "BMSK",
            "SGXT", "VIADD", "VIMNMX", "IABS", "FLO", "POPC", "BREV", "I2FP"),
    "fma-heavy (int)": ("IMAD", "IMUL", "IDP", "IMADSP"),
    "fma (fp32)": ("FFMA", "FADD", "FMUL", "FCHK"),
    "16-lane": ("MUFU", "I2F", "F2I", "F2F", "FRND", "F2FP"),
    "memory": ("LDS", "LDG", "STG", "STS", "LDC", "LD", "ST", "LDL", "STL",
               "ATOM", "RED", "LDSM"),
}
PIPE_OF = {op: pipe for pipe, ops in PIPE.items() for op in ops}
# splitmix32's first multiplier as cuobjdump prints an immediate (signed)
MIX_CONST = ("0x85ebca6b", "-0x7a143595")


def pipe_of(opcode: str) -> str:
    base = opcode.split(".")[0]
    if base.startswith("U") and base[1:] in PIPE_OF or base in ("ULDC", "UMOV"):
        return "uniform"
    return PIPE_OF.get(base, "control")


def tool(name: str) -> str:
    found = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not Path(found).exists():
        raise SystemExit(f"gauss_profile: {name} not found")
    return found


def kernel_name(mangled: str) -> str:
    m = re.match(r"_Z(\d+)", mangled)
    return mangled[m.end():m.end() + int(m.group(1))] if m else mangled


def sass_functions(text: str) -> dict[str, list[tuple[int, str, str]]]:
    """{kernel: [(address, opcode, instruction)]} of cuobjdump -sass."""
    funcs, cur, labels = {}, None, {}
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(kernel_name(m.group(1)), [])
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m and cur is not None:
            labels[m.group(1)] = None       # bound to the next instruction
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and cur is not None:
            addr, ins = int(m.group(1), 16), m.group(2)
            for k, v in labels.items():
                if v is None:
                    labels[k] = addr
            op = ins.split()[1] if ins.startswith("@") else ins.split()[0]
            cur.append((addr, op, ins))
    for ins_list in funcs.values():      # labels -> addresses in branches
        for i, (addr, op, ins) in enumerate(ins_list):
            m = re.search(r"`\((\.L_x_\d+)\)", ins)
            if m and labels.get(m.group(1)) is not None:
                ins_list[i] = (addr, op, ins.replace(m.group(0), hex(labels[m.group(1)])))
    return funcs


def inner_loop(ins: list[tuple[int, str, str]]):
    """(instructions, elements of R per iteration) of the innermost loop
    with the most splitmix32 multiplies, or (None, 0): of the loops (a
    backward branch and its target) that hold a multiply and no other such
    loop, the one with the most."""
    loops = []
    for addr, op, text in ins:
        m = re.search(r"BRA\S*\s+.*?(0x[0-9a-f]+)", text)
        if op.startswith("BRA") and m and int(m.group(1), 16) <= addr:
            body = [t for t in ins if int(m.group(1), 16) <= t[0] <= addr]
            mults = sum(any(c in t[2] for c in MIX_CONST) for t in body)
            if mults:
                loops.append((body[0][0], addr, mults, body))
    inner = [lp for lp in loops
             if not any(o is not lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]
    if not inner:
        return None, 0
    body, mults = max(inner, key=lambda lp: lp[2])[3], max(lp[2] for lp in inner)
    return body, mults / 2


def print_sass(lib: Path, sass_out: str | None, opcodes: bool = True) -> None:
    """Registers of each kernel, and its inner loop's SASS per element of R:
    by pipe, and with ``opcodes`` by opcode."""
    res = subprocess.run([tool("cuobjdump"), "-res-usage", str(lib)],
                         capture_output=True, text=True).stdout
    for line in res.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            name = kernel_name(m.group(1))
        elif "REG:" in line and opcodes:
            print(f"  {name}: {line.strip()}")
    text = subprocess.run([tool("cuobjdump"), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    if sass_out:
        Path(sass_out).parent.mkdir(parents=True, exist_ok=True)
        Path(sass_out).write_text(text)
    for name, ins in sass_functions(text).items():
        body, per_iter = inner_loop(ins)
        if body is None:
            if opcodes:
                print(f"{name}: {len(ins)} instructions, no generator loop")
            continue
        ops = collections.Counter(op for _, op, _ in body)
        pipes = collections.Counter()
        for op, k in ops.items():
            pipes[pipe_of(op)] += k
        print(f"{name}: inner loop {len(body)} instructions for {per_iter:g} "
              f"elements of R; per element {len(body) / per_iter:.2f}: "
              + ", ".join(f"{p} {k / per_iter:.2f}" for p, k in pipes.most_common()))
        for op, k in ops.most_common() if opcodes else ():
            print(f"    {op:<22} {k / per_iter:6.2f}  {pipe_of(op)}")


def events_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def kernel_ms(fn, calls: int) -> dict[str, float]:
    """Device ms per launch of each kernel fn launches (torch.profiler),
    with the launches it saw."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
        if t > 0 and "gaussian" in e.key:
            out[f"{e.key.split('(')[0][:40]} (x{e.count})"] = t / e.count / 1e3
    return out


def clocks_under_load(fn, seconds: float = 1.5) -> str:
    """The SM clock (MHz) and power draw (W) that nvidia-smi reads every
    100 ms while fn() runs back to back: min, median, max."""
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        fn()
        torch.cuda.synchronize()
    smi.terminate()
    rows = [line.split(",") for line in smi.communicate()[0].splitlines()[2:]]
    if not rows:
        return "no nvidia-smi readings"
    out = []
    for k, unit in ((0, "MHz"), (1, "W")):
        v = sorted(float(r[k]) for r in rows)
        out.append(f"{v[0]:.0f}/{v[len(v) // 2]:.0f}/{v[-1]:.0f} {unit}")
    return f"SM clock {out[0]}, power {out[1]} (min/median/max of {len(rows)})"


# variants of csrc/gaussian_sketch.cu: (name, [(line, replacement)]), each
# one choice of the kept design undone, or a form it did not take
MIX = """\
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  return (float)((x ^ (x >> 16)) & 0xFFFFFF00u);"""
U1 = "fmaf(top24(x), 0x1p-32f,"
V2 = "  const float v2 = fmaf(top24(x * ONE + 1u), 0x1p-32f, 0x1p-24f - 0.5f);"
RET = "  return sqrt_approx(fabsf(lg2_approx(u1))) * cos_approx(6.2831855f * v2);"
STEP = "    x[v] = x[v] * ONE + stride;"
VARIANTS = [
    ("counters stepped on the integer ALU (x + c, no ONE)", [
        (STEP, "    x[v] += stride;"), (V2, V2.replace("x * ONE + 1u", "x + 1u"))]),
    ("4 columns or rows a thread", [("#define SK_COLS 2", "#define SK_COLS 4"),
                                    ("#define DESK_ROWS 2", "#define DESK_ROWS 4")]),
    ("k shifted down (>> 8) before I2FP", [
        (MIX, MIX.replace("& 0xFFFFFF00u);", ">> 8);")),
        (U1, U1.replace("0x1p-32f", "0x1p-24f")), (V2, V2.replace("0x1p-32f", "0x1p-24f"))]),
    ("k from two 16-bit halves OR-ed into floats, no I2FP", [(MIX, """\
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  const uint32_t hi = __byte_perm(x, 0x4B000000u, 0x7543);  // 2^23 + (x >> 24)
  const uint32_t lo = __byte_perm(x, 0x4B000000u, 0x7521) ^ (hi & 0xFFu);
  return 256.0f * fmaf(__uint_as_float(hi) - 8388608.0f, 65536.0f,
                       __uint_as_float(lo) - 8388608.0f);""")]),
    ("shifts as __umulhi by 2^k (IMAD.HI on the FMA-heavy pipe)", [(MIX, """\
  x = (x ^ __umulhi(x, 1u << 16)) * 0x85EBCA6Bu;
  x = (x ^ __umulhi(x, 1u << 19)) * 0xC2B2AE35u;
  return (float)((x ^ __umulhi(x, 1u << 16)) & 0xFFFFFF00u);""")]),
    ("cos argument in one FFMA (u2 not formed)", [
        (V2, "  const float v2 = top24(x * ONE + 1u);"),
        (RET, "  return sqrt_approx(fabsf(lg2_approx(u1))) * cos_approx(fmaf(v2, "
              "6.2831855f * 0x1p-32f, 6.2831855f * (0x1p-24f - 0.5f)));")]),
    ("accurate library log2, sqrt, cos", [
        (RET, "  return sqrtf(-log2f(u1)) * cosf(6.2831855f * v2);")]),
]


SK_COLS: dict[str, int] = {}    # each variant's columns a thread


def build_variants() -> dict[str, ctypes.CDLL]:
    from repro_torch.kernels import build
    src = (HERE / "src" / "repro_torch" / "csrc" / "gaussian_sketch.cu").read_text()
    out = HERE / "build" / "gauss_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS):
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"gauss_profile: {name}: line not found: {old!r}")
            text = text.replace(old, new)
        cu, lib = out / f"v{i}.cu", out / f"libv{i}.so"
        cu.write_text(text)
        SK_COLS[name] = int(re.search(r"#define SK_COLS (\d+)", text).group(1))
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"gauss_profile: {name}: nvcc failed\n{log}")
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"variant {name!r}: {'; '.join(regs)}")
        print_sass(lib, None, opcodes=False)
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def run_variants(gs, build) -> None:
    kept, kept_cols = build.load("gaussian_sketch"), gs.SK_COLS
    libs = {"kept": kept, **build_variants()}
    SK_COLS["kept"] = kept_cols

    def use(name):
        build._LIBS["gaussian_sketch"] = libs[name]
        gs.SK_COLS = SK_COLS[name]
        gs._sk_slots.cache_clear()

    n, b = ATT
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(n, generator=gen, device="cuda")
    s = torch.randn(b, generator=gen, device="cuda")
    calls = {"sk": lambda: gs.gaussian_sk_cuda(SEED, x, b),
             "desk": lambda: gs.gaussian_desk_cuda(SEED, s, n)}
    ref = {k: f() for k, f in calls.items()}
    order = list(libs) + list(libs)[::-1]
    times = collections.defaultdict(list)
    for name in order:
        use(name)
        for k, f in calls.items():
            times[(name, k)].append(events_ms(f, 2))
    for name in libs:
        use(name)
        diffs = []
        for k, f in calls.items():
            got = f()
            diffs.append(f"{k} {float((got - ref[k]).abs().max() / ref[k].abs().max()):.2e}")
        print(f"variant {name!r}: sk {times[(name, 'sk')]} ms, desk "
              f"{times[(name, 'desk')]} ms; max |diff| / max |kept|: {', '.join(diffs)}")
    use("kept")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--sass", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gauss_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import gaussian_sketch as gs
    sys.path.insert(1, str(HERE))
    import chip_smoke      # its bound; repro_torch is already the root's
    print(f"gauss_profile: kernels of {gs.__file__}")
    print(chip_smoke.smi_line())
    report = build.build_all()
    for line in report.get("gaussian_sketch", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  nvcc: {line.strip()}")
    print_sass(build._build_dir() / "libgaussian_sketch.so", args.sass)

    clock = chip_smoke.max_sm_clock_hz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n, b in (ATT, BIG):
        x = torch.randn(n, generator=gen, device="cuda")
        s = torch.randn(b, generator=gen, device="cuda")
        terms = chip_smoke.gauss_bound_terms(n, b, clock, sms)
        print(f"(n, b)=({n}, {b}): bound terms (ms) "
              + ", ".join(f"{k} {v:.3f}" for k, v in terms.items()))
        for k, fn in (("sk", lambda: gs.gaussian_sk_cuda(SEED, x, b)),
                      ("desk", lambda: gs.gaussian_desk_cuda(SEED, s, n))):
            ev = events_ms(fn, 3)
            per = ", ".join(f"{name} {t:.3f}" for name, t in kernel_ms(fn, 2).items())
            print(f"  {k}: events {ev:.3f} ms; device ms per call: {per}")
            if (n, b) == ATT:
                print(f"    under load: {clocks_under_load(fn)}")
        del x, s

    n = 1 << 24
    one = torch.ones(1, device="cuda")
    got = gs.gaussian_desk_cuda(SEED, one, n)
    want = gs.gaussian_desk_plain(SEED, one, n)
    err = (got - want).abs()
    print(f"R over 2**24 elements (desk, b = 1): max |err| {float(err.max()):.3e} "
          f"at R = {float(want[int(err.argmax())]):.4f}; mean |err| "
          f"{float(err.mean()):.3e}; non-finite {int((~torch.isfinite(got)).sum())}")
    if args.variants:
        run_variants(gs, build)
    return 0


if __name__ == "__main__":
    sys.exit(main())
