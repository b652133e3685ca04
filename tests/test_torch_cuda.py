"""The port on a CUDA card: kernels against their plain versions, and the
driver's bitwise scan-vs-host-loop pin through the kernels.

The CUDA kernels have no CPU mode, so the ``cuda``-marked tests skip
without a card.  This file imports neither jax nor the reference, so it
also runs on a card machine without them:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import functools
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.core.adaptive import AdaConfig
from repro_torch.core.baselines import (BaselineConfig, baseline_round,
                                        init_baseline_state)
from repro_torch.core.clipped import ClippedSAFLConfig, clipped_safl_round
from repro_torch.core.packed import make_packing_plan
from repro_torch.core.safl import SAFLConfig, init_safl, safl_round
from repro_torch.core.sketch import SketchConfig
from repro_torch.data.synthetic import BigramLMData, LMDataConfig
from repro_torch.fed import ImportanceParticipation, UniformParticipation
from repro_torch.kernels import countsketch as cs
from repro_torch.kernels import fwht as fw
from repro_torch.kernels import gaussian_sketch as gs
from repro_torch.launch.driver import run_host_loop, run_scan
from repro_torch.models.config import ModelConfig
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.intrinsic_dim import make_hvp
from repro_torch.models.model import init_params, loss_fn

torch.set_num_threads(2)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")


def test_port_imports_neither_jax_nor_the_reference():
    """Every module of the port, and chip_smoke.py, load without jax or
    ``repro`` (a fresh interpreter, so nothing else has imported them)."""
    root = pathlib.Path(__file__).resolve().parents[1]
    mods = sorted("repro_torch." + ".".join(p.relative_to(root / "src" / "repro_torch")
                                            .with_suffix("").parts)
                  for p in (root / "src" / "repro_torch").rglob("*.py")
                  if p.name != "__init__.py")
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import chip_smoke\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": f"{root / 'src'}{os.pathsep}{root}"}
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=root)


def test_cuda_wrappers_reject_cpu_tensors():
    x, h = torch.zeros((2, 8)), torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError):
        cs.countsketch_clients_cuda(x, h, 4)
    with pytest.raises(ValueError):
        fw.fwht_rows_cuda(x)
    with pytest.raises(ValueError):
        gs.gaussian_sk_cuda(3, x[0], 4)
    with pytest.raises(ValueError):
        gs.gaussian_desk_cuda(3, x[0], 16)


@pytest.mark.parametrize("n,b", [(132_008_448, 2_640_275), (5000, 8),
                                 (3000, 3000), (3000, 3001), (3000, 4096),
                                 (70_779, 1 << 22), (17, 1 << 22), (0, 64),
                                 (1 << 20, 1 << 26), (1 << 26, 1 << 26),
                                 (132_008_448, 1_320_138), (132_008_448, 660_069),
                                 (132_008_448, (1 << 22) + 1), (132_008_448, 131_073),
                                 (1 << 30, 1 << 20)])
def test_countsketch_route(n, b):
    """Below ``COARSE_MIN_N`` or with b > n: one slot per window when
    n >= b; when b > n, 8-16 indices per window on average, so the bins
    number at most ~n/16 and not b.  From it on with n >= b: the large-n
    route, with the widest windows that keep them at most
    ``COARSE_WINDOWS`` and their mean at most ``FILL`` records, or as close
    to that mean as ``MAX_WINDOWS`` windows come."""
    width, large = cs.route(n, b)
    bins = -(-b // width)
    assert width >= 1 and width & (width - 1) == 0
    if large:
        assert n >= cs.COARSE_MIN_N and n >= b and width <= cs.BIG_SLOTS
        assert bins <= cs.MAX_WINDOWS
        assert (n * width <= cs.FILL * b or width == 1
                or -(-b // (width // 2)) > cs.MAX_WINDOWS)
        wider = 2 * width
        assert -(-b // wider) > cs.COARSE_WINDOWS or n * wider > cs.FILL * b
    elif n >= b:
        assert width == 1
    else:
        assert width > 1 and bins <= max(-(-n // 16), 1) and n <= 32 * bins
    assert cs.route(132_008_448, 2_640_275) == (32, True)


def test_countsketch_limits_come_from_the_source():
    """The wrapper's limits are the kernels' own, read from their source."""
    text = (pathlib.Path(cs.build.CSRC) / "countsketch.cu").read_text()
    for name, value in (("CS_ROWS", cs.ROWS), ("CS_BIG_SLOTS", cs.BIG_SLOTS),
                        ("CS_BIG_CAP", cs.BIG_CAP), ("CS_MAX_WINDOWS", cs.MAX_WINDOWS)):
        assert f"#define {name} {value}" in text
    assert cs.COARSE_WINDOWS < cs.MAX_WINDOWS and cs.FILL < cs.BIG_CAP


def _sequential_sum(x: torch.Tensor, h: torch.Tensor, b: int) -> torch.Tensor:
    """Each slot from 0 over ascending i, one float32 addition at a time."""
    out = torch.zeros((x.shape[0], b), dtype=torch.float32)
    for i, j in enumerate(h.tolist()):
        if 0 <= j < b:
            out[:, j] = out[:, j] + x[:, i]
    return out


@pytest.mark.parametrize("g,n,b,hash_kind", [
    (1, 3000, 1, "zero"), (3, 2000, 17, "random"), (2, 300, 4096, "random"),
    (13, 500, 300, "random"), (2, 0, 5, "random"), (2, 400, 50, "outside")])
def test_countsketch_ordered_is_a_sequential_loop(g, n, b, hash_kind):
    """The order the route must reproduce bit for bit: the ordered reference
    equals a sequential loop over i exactly, and the plain version within
    the tolerance of the same terms in another order."""
    gen = torch.Generator().manual_seed(n + b)
    x = torch.randn((g, n), generator=gen)
    h = (torch.zeros(n, dtype=torch.int64) if hash_kind == "zero"
         else torch.randint(-5 if hash_kind == "outside" else 0,
                            b + 5 if hash_kind == "outside" else b, (n,), generator=gen))
    got = cs.countsketch_clients_ordered(x, h, b)
    assert torch.equal(got, _sequential_sum(x, h, b))
    if hash_kind != "outside":
        scale = float(cs.countsketch_clients_plain(x.abs(), h, b).max())
        torch.testing.assert_close(got, cs.countsketch_clients_plain(x, h, b),
                                   rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("x,h,b,match", [
    (torch.zeros(8), torch.zeros(8, dtype=torch.int32), 4, "x must be"),
    (torch.zeros((2, 8), dtype=torch.float64), torch.zeros(8, dtype=torch.int32),
     4, "x must be"),
    (torch.zeros((8, 2)).t(), torch.zeros(8, dtype=torch.int32), 4, "x must be"),
    (torch.zeros((2, 8)), torch.zeros(7, dtype=torch.int32), 4, "h must be"),
    (torch.zeros((2, 8)), torch.zeros(16, dtype=torch.int32)[::2], 4, "h must be"),
    (torch.zeros((2, 8)), torch.zeros(8), 4, "h must be an integer"),
    (torch.zeros((2, 8)), torch.zeros(8, dtype=torch.int32), -1, "int32"),
    (torch.zeros((2, 8)), torch.zeros(8, dtype=torch.int32), 1 << 31, "int32"),
    (torch.zeros((2, 8)), torch.zeros(8, dtype=torch.int32), 4, "CUDA device")])
def test_countsketch_cuda_checks_its_arguments(x, h, b, match):
    """The count-sketch route raises on what its kernels do not take, before
    anything reaches the card."""
    with pytest.raises(ValueError, match=match):
        cs.countsketch_clients_cuda(x, h, b)


# B2 on the card: edge shapes, and each (R, C) group of an lm25m SRHT round
# (n2 = 512, 4096, 2^20, 2^21, 2^22) with small R
FWHT_CARD_SHAPES = [(1, 1), (1, 2), (3, 4), (5, 16), (3, 2048), (7, 8192), (33, 4096),
                    (2, 16384), (1, 1 << 24), (3, 512), (2, 4096), (2, 1 << 20),
                    (3, 1 << 21), (2, 1 << 22)]


@pytest.mark.cuda
def test_kernels_match_plain_versions():
    """Each kernel against its plain version at the reference's test
    shapes.  Count-sketch: the same float32 terms summed in another order
    (the plain ``index_add_`` uses atomics), a few ulps of the slot sum;
    FWHT: the same additions in the same order, bit for bit."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for g, n, b in [(1, 17, 8), (1, 5000, 300), (1, 3000, 4096), (9, 1500, 3000)]:
        x = torch.randn((g, n), generator=gen, device="cuda")
        h = torch.randint(0, b, (n,), generator=gen, device="cuda")
        torch.testing.assert_close(cs.countsketch_clients_cuda(x, h, b),
                                   cs.countsketch_clients_plain(x, h, b),
                                   rtol=1e-5, atol=1e-4)
    for shape in [(1, 8), (9, 4096), (20, 512), (2, 32768)]:
        x = torch.randn(shape, generator=gen, device="cuda")
        torch.testing.assert_close(fw.fwht_rows_cuda(x), fw.fwht_plain(x),
                                   rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("g,n,b,hash_kind", [
    (1, 100_000, 1, "zero"), (1, 100_000, 300, "zero"),
    (1, 17, 1 << 22, "random"), (1, 70_779, 1 << 22, "random"),
    (13, 5000, 300, "random"), (3, 0, 64, "random"),
    (7, cs.COARSE_MIN_N + 12_345, 30_000, "random"),
    (2, cs.COARSE_MIN_N + 12_345, 5_000, "random"),
    (1, cs.COARSE_MIN_N + 12_345, 600, "random"),
    (1, cs.COARSE_MIN_N + 12_345, 100, "random")])
def test_countsketch_edge_cases_match_plain(g, n, b, hash_kind):
    """The count-sketch route where its windows are long (all of n in one
    slot), where b >> n (windows of many slots), at G = 13 (three chunks of
    rows), at n = 0, and on the large-n route at G = 7, with slots of ~200
    and ~1,800 indices (ranked by a whole block) and windows of ~10,600
    (the long-window kernel).  Bit for bit the sum in ascending index order
    (``countsketch_clients_ordered``, on the CPU); and the plain
    ``index_add_``, the same float32 terms summed in another order (atomics),
    within 1e-5 of the largest absolute slot sum."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(n + b)
    x = torch.randn((g, n), generator=gen, device="cuda")
    h = (torch.zeros(n, dtype=torch.int64, device="cuda") if hash_kind == "zero"
         else torch.randint(0, b, (n,), generator=gen, device="cuda"))
    got = cs.countsketch_clients_cuda(x, h, b)
    assert torch.equal(got.cpu(), cs.countsketch_clients_ordered(x.cpu(), h.cpu(), b))
    scale = float(cs.countsketch_clients_plain(x.abs(), h, b).max())
    torch.testing.assert_close(got, cs.countsketch_clients_plain(x, h, b),
                               rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("g,n,b", [(5, 200_000, 4_000), (1, 70_779, 1 << 22),
                                   (5, cs.COARSE_MIN_N + 12_345, 30_000)])
def test_countsketch_two_calls_bitwise_equal(g, n, b):
    """The route places records in an order that depends on the run (on
    both routes), but sums each slot in ascending index order: the same
    bits every call, those of the ordered sum."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(g + n)
    x = torch.randn((g, n), generator=gen, device="cuda")
    h = torch.randint(0, b, (n,), generator=gen, device="cuda", dtype=torch.int32)
    first = cs.countsketch_clients_cuda(x, h, b)
    assert torch.equal(first, cs.countsketch_clients_cuda(x, h, b))
    assert torch.equal(first, cs.countsketch_clients_ordered(x, h, b))


@pytest.mark.cuda
@pytest.mark.parametrize("g,n,b,calls,device_launches", [
    (0, 1000, 64, 0, 0),                  # nothing to compute: no launch
    (3, 0, 64, 1, 2),                     # small-n route: memset + kernel
    (1, 70_779, 1 << 22, 1, 2),
    # large-n route, two chunks of rows: memset + histogram, the scan's 3,
    # then per chunk 2 grouping passes (and a memset of the cursors after
    # the first) and the 2 reduce kernels
    (7, cs.COARSE_MIN_N + 12_345, 30_000, 1, 2 + 3 + 4 + 5)])
def test_countsketch_counts_what_it_launches(g, n, b, calls, device_launches):
    """``LAUNCHES`` counts calls that launched, ``DEVICE_LAUNCHES`` the
    kernels and memsets each entry point reports it put on the stream."""
    _need_card()
    x = torch.randn((g, n), device="cuda")
    h = torch.randint(0, b, (n,), device="cuda")
    cs.LAUNCHES.n = cs.DEVICE_LAUNCHES.n = 0
    cs.countsketch_clients_cuda(x, h, b)
    assert (cs.LAUNCHES.n, cs.DEVICE_LAUNCHES.n) == (calls, device_launches)


@pytest.mark.cuda
@pytest.mark.parametrize("sketch", [
    SketchConfig(kind="countsketch", cs_hash="independent", ratio=0.05,
                 min_b=16, use_kernels=True),
    SketchConfig(kind="srht", ratio=0.05, min_b=16, use_kernels=True)])
def test_scan_equals_host_loop_bitwise_through_kernels(sketch):
    """Kernels that reduce in a fixed order keep the driver's pin on the
    card: chunked rounds == one-at-a-time rounds, bit for bit."""
    _need_card()
    model = ModelConfig(name="tiny", arch_type="dense", num_layers=2,
                        d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                        vocab_size=128)
    cfg = SAFLConfig(sketch=sketch, server=AdaConfig(name="amsgrad", lr=0.01),
                     client_lr=0.5, local_steps=2)
    sampler = BigramLMData(LMDataConfig(vocab_size=128, seq_len=16,
                                        num_clients=3, alpha=0.05)
                           ).device_sampler(4, 2)
    fresh = lambda: init_params(model, torch.Generator().manual_seed(0))
    fn = functools.partial(safl_round, cfg, lambda p, b: loss_fn(model, p, b),
                           plan=make_packing_plan(cfg.sketch, fresh()))
    launches = cs.LAUNCHES.n + fw.LAUNCHES.n
    p1, s1, h1 = run_scan(fn, sampler, fresh(), init_safl(cfg, fresh()),
                          rounds=3, key=prng.key(4), chunk_size=2)
    p2, s2, h2 = run_host_loop(fn, sampler, fresh(), init_safl(cfg, fresh()),
                               rounds=3, key=prng.key(4))
    assert cs.LAUNCHES.n + fw.LAUNCHES.n > launches
    assert (h1["loss"] == h2["loss"]).all()
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k


@pytest.mark.cuda
def test_sacfl_with_participation_on_card_matches_cpu():
    """Two SACFL rounds under uniform participation through the kernels on
    the card against the same rounds on the CPU (plain versions): the
    cohort masks bit for bit (also the importance policy's over 32
    rounds), losses and parameters within chip_smoke's card-against-CPU
    tolerances (float32 matmul orders, amplified by AMSGrad's normalized
    step in near-zero sketch slots)."""
    _need_card()
    model = ModelConfig(name="tiny", arch_type="dense", num_layers=2,
                        d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                        vocab_size=128)
    sketch = SketchConfig(kind="countsketch", cs_hash="independent", ratio=0.05,
                          min_b=16, use_kernels=True)
    cfg = ClippedSAFLConfig(
        base=SAFLConfig(sketch=sketch, server=AdaConfig(name="amsgrad", lr=0.01),
                        client_lr=0.5, local_steps=2), clip_tau=0.5)
    sampler = BigramLMData(LMDataConfig(vocab_size=128, seq_len=16,
                                        num_clients=5, alpha=0.05)
                           ).device_sampler(4, 2)
    policy = UniformParticipation(5, frac=0.4, seed=123)

    def run(device):
        params = init_params(model, torch.Generator().manual_seed(0), device)
        fn = functools.partial(clipped_safl_round, cfg,
                               lambda p, b: loss_fn(model, p, b),
                               plan=make_packing_plan(sketch, params))
        return run_scan(fn, sampler, params, init_safl(cfg.base, params),
                        rounds=2, key=prng.key(1), participation=policy,
                        bits_per_round=1000)

    launches = cs.LAUNCHES.n
    pg, _, hg = run("cuda")
    assert cs.LAUNCHES.n >= launches + 2
    pc, _, hc = run("cpu")
    assert (hg["uplink_bits"] == hc["uplink_bits"]).all()
    torch.testing.assert_close(torch.from_numpy(hg["loss"]),
                               torch.from_numpy(hc["loss"]), rtol=1e-4, atol=1e-4)
    for k in pc:
        torch.testing.assert_close(pg[k].cpu(), pc[k], rtol=1e-3, atol=2e-3)
    importance = ImportanceParticipation(5, (0.1, 0.3, 0.2, 0.15, 0.25), frac=0.4)
    for t in range(32):
        assert torch.equal(policy.mask(t, "cuda").cpu(), policy.mask(t, "cpu"))
        assert torch.equal(importance.mask(t, "cuda")["w"].cpu(),
                           importance.mask(t, "cpu")["w"])


@pytest.mark.cuda
@pytest.mark.parametrize("n,b", [(132_008_448, 2_640_275), (3 * cs.COARSE_MIN_N, 60_000)])
def test_countsketch_resketch_shape_bitwise(n, b):
    """B1 at FetchSGD's re-sketch of its top-k update: G = 1 over all of
    d_total (bert_100m's at ratio 0.02, and a smaller one), on the large-n
    route, bit for bit the sum in ascending index order.  The input is the
    update's shape of data: 2% of the coordinates nonzero."""
    _need_card()
    assert cs.route(n, b)[1]
    gen = torch.Generator(device="cuda").manual_seed(b)
    x = torch.randn((1, n), generator=gen, device="cuda") * 1e-3
    x = torch.where(torch.rand((1, n), generator=gen, device="cuda") < 0.02, x, 0.0)
    h = torch.randint(0, b, (n,), generator=gen, device="cuda", dtype=torch.int32)
    got = cs.countsketch_clients_cuda(x, h, b)
    assert torch.equal(got, cs.countsketch_clients_ordered(x, h, b))
    assert torch.equal(got, cs.countsketch_clients_cuda(x, h, b))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fetchsgd", "topk_ef"])
def test_baseline_round_on_card_matches_cpu(name):
    """One round of FetchSGD (its uplink and its re-sketch through B1) and
    of topk_ef on the card against the CPU port, from the same weights:
    losses within 1e-4, parameters within chip_smoke's card-against-CPU
    tolerance, where a coordinate at a top-k threshold kept on one device
    and not the other moves alone (at most one in a thousand of the k
    kept may)."""
    _need_card()
    model = ModelConfig(name="tiny", arch_type="dense", num_layers=2,
                        d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                        vocab_size=128)
    sketch = SketchConfig(kind="countsketch", cs_hash="independent", ratio=0.05,
                          min_b=16, use_kernels=True)
    cfg = BaselineConfig(name=name, client_lr=0.5, local_steps=2,
                         server=AdaConfig(name="sgd", lr=1.0), topk_ratio=0.05,
                         sketch=sketch)
    sampler = BigramLMData(LMDataConfig(vocab_size=128, seq_len=16,
                                        num_clients=5, alpha=0.05)
                           ).device_sampler(4, 2)

    def run(device):
        params = init_params(model, torch.Generator().manual_seed(0), device)
        plan = make_packing_plan(sketch, params)
        fn = functools.partial(baseline_round, cfg, lambda p, b: loss_fn(model, p, b),
                               plan=plan)
        return run_scan(fn, sampler, params,
                        init_baseline_state(cfg, params, 5, plan=plan),
                        rounds=1, key=prng.key(2))

    launches = cs.LAUNCHES.n
    pg, sg, hg = run("cuda")
    assert cs.LAUNCHES.n == launches + (2 if name == "fetchsgd" else 0)
    pc, sc, hc = run("cpu")
    torch.testing.assert_close(torch.from_numpy(hg["loss"]),
                               torch.from_numpy(hc["loss"]), rtol=1e-4, atol=1e-4)
    d = sum(p.numel() for p in pc.values())
    outside = sum(int((~torch.isclose(pg[k].cpu(), pc[k], rtol=1e-3, atol=2e-3)).sum())
                  for k in pc)
    assert outside <= int(d * cfg.topk_ratio) // 1000, outside
    assert int(sg["round"]) == int(sc["round"]) == 1


def _tiny_streamed_setup(g=5):
    model = ModelConfig(name="tiny", arch_type="dense", num_layers=2,
                        d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                        vocab_size=128)
    sketch = SketchConfig(kind="countsketch", cs_hash="independent", ratio=0.05,
                          min_b=16, use_kernels=True)
    cfg = SAFLConfig(sketch=sketch, server=AdaConfig(name="amsgrad", lr=0.01),
                     client_lr=0.5, local_steps=2)
    sampler = BigramLMData(LMDataConfig(vocab_size=128, seq_len=16,
                                        num_clients=g, alpha=0.05)
                           ).device_sampler(4, 2)
    return model, cfg, sampler


@pytest.mark.cuda
def test_streamed_round_on_card_matches_cpu():
    """Two streamed SAFL rounds (microbatch 2 of 5, the tail chunk masked)
    under scripted faults, the two-pass norm sentinel and the int8 codec
    with EF, through B1 on the card against the CPU's plain versions:
    the guard's counters and the measured bits exactly, losses within
    1e-4 and parameters within chip_smoke's card-against-CPU tolerance
    (float32 matmul orders, amplified by AMSGrad's normalized step), up
    to one in a thousand of d outside it: a payload coordinate at a
    rounding boundary decodes one int8 level apart on the two devices and
    moves the coordinates hashed into its slot (chip_smoke phase 9a)."""
    _need_card()
    from repro_torch.fed import CodecConfig, FaultTable, SentinelConfig
    from repro_torch.fed.faults import BYZANTINE, NAN, OK
    model, cfg, sampler = _tiny_streamed_setup()
    faults = FaultTable(((OK, NAN, OK, BYZANTINE, OK),))
    codec = CodecConfig(bits=8)

    def run(device):
        params = init_params(model, torch.Generator().manual_seed(0), device)
        plan = make_packing_plan(cfg.sketch, params)
        fn = functools.partial(safl_round, cfg, lambda p, b: loss_fn(model, p, b),
                               plan=plan, sentinel=SentinelConfig(norm_mult=10.0))
        state = {"opt": init_safl(cfg, params),
                 "ef": torch.zeros((5, plan.b_total), device=device)}
        return run_scan(fn, sampler, params, state, rounds=2, key=prng.key(1),
                        faults=faults, microbatch=2, codec=codec)

    launches = cs.LAUNCHES.n
    pg, sg, hg = run("cuda")
    assert cs.LAUNCHES.n == launches + 2 * 2 * 3      # 2 passes x 3 chunks x 2 rounds
    pc, sc, hc = run("cpu")
    for k in ("n_dropped", "n_rejected", "diverged", "uplink_bits"):
        assert (hg[k] == hc[k]).all(), k
    assert list(hg["n_rejected"]) == [2, 0]
    torch.testing.assert_close(torch.from_numpy(hg["loss"]),
                               torch.from_numpy(hc["loss"]), rtol=1e-4, atol=1e-4)
    d = sum(p.numel() for p in pc.values())
    outside = sum(int((~torch.isclose(pg[k].cpu(), pc[k], rtol=1e-3, atol=2e-3)).sum())
                  for k in pc)
    assert outside <= d // 1000, (outside, d)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [1, 8])
def test_quantize_rows_on_card_equals_cpu(bits):
    """The codec's rows on the card bit for bit the CPU's: integer threefry
    uniforms, an exact max, IEEE float32 division and multiplies."""
    _need_card()
    from repro_torch.fed.codec import CodecConfig, encode_decode
    gen = torch.Generator().manual_seed(bits)
    rows = torch.randn((6, 100_003), generator=gen) * torch.rand((6, 1), generator=gen)
    rows[2] = 0.0
    ef = torch.randn((6, 100_003), generator=gen) * 1e-3
    codec = CodecConfig(bits=bits)
    key = prng.fold_in(prng.key(3), 4)
    ids = [7, 0, 3, 9, 1, 2]
    dc, ec = encode_decode(codec, key, rows, ef, ids)
    dg, eg = encode_decode(codec, key, rows.cuda(), ef.cuda(), ids)
    assert torch.equal(dg.cpu(), dc) and torch.equal(eg.cpu(), ec)


@pytest.mark.cuda
def test_two_pass_streamed_round_on_card_repeats_bitwise():
    """Pass 2 recomputes pass 1's payloads through B1, which sums in a
    fixed order: two runs of the two-pass round on the card are bit for
    bit, counters and parameters."""
    _need_card()
    from repro_torch.fed import FaultTable, SentinelConfig
    from repro_torch.fed.faults import BYZANTINE, DROP, OK
    model, cfg, sampler = _tiny_streamed_setup()

    def run():
        params = init_params(model, torch.Generator().manual_seed(0), "cuda")
        fn = functools.partial(safl_round, cfg, lambda p, b: loss_fn(model, p, b),
                               plan=make_packing_plan(cfg.sketch, params),
                               sentinel=SentinelConfig(norm_mult=10.0))
        return run_scan(fn, sampler, params, init_safl(cfg, params), rounds=2,
                        key=prng.key(2), microbatch=2,
                        faults=FaultTable(((OK, DROP, OK, BYZANTINE, OK),)))

    (p1, s1, h1), (p2, s2, h2) = run(), run()
    for k in h1:
        assert (h1[k] == h2[k]).all(), k
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k
    for name in ("m", "v", "vhat"):
        for k in s1[name]:
            assert torch.equal(s1[name][k], s2[name][k]), (name, k)


@pytest.mark.cuda
def test_telemetry_round_on_card_matches_cpu():
    """One SAFL round with every probe on the card (B1) against the CPU
    (plain): the norms within rtol 1e-4, the cohort exactly, every probe
    a float32 scalar on the round's device."""
    _need_card()
    from repro_torch.obs import Telemetry
    model, cfg, sampler = _tiny_streamed_setup()
    out = {}
    for device in ("cuda", "cpu"):
        params = init_params(model, torch.Generator().manual_seed(0), device)
        fn = functools.partial(safl_round, cfg, lambda p, b: loss_fn(model, p, b),
                               plan=make_packing_plan(cfg.sketch, params),
                               telemetry=Telemetry())
        batch = sampler.sample(sampler.init_state(device), 0)[1]
        out[device] = fn(params, init_safl(cfg, params), batch, prng.key(4))[2]
    for k, v in out["cuda"].items():
        assert v.device.type == "cuda" and v.dtype == torch.float32 and v.dim() == 0, k
    assert set(out["cuda"]) == set(out["cpu"])
    assert float(out["cuda"]["cohort"]) == float(out["cpu"]["cohort"]) == 5.0
    for k in out["cpu"]:
        torch.testing.assert_close(out["cuda"][k].cpu(), out["cpu"][k],
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
def test_supervised_rollback_relaunches_on_the_card():
    """A transient NaN client (rounds 2 and 3 under the original key) rolls
    the supervisor back to round 2; the relaunched rounds run on the card,
    through B1, and finish finite."""
    _need_card()
    from repro_torch.fed.faults import NAN, OK, _spec_from_codes
    from repro_torch.launch.supervisor import SupervisorConfig, run_supervised
    model, cfg, sampler = _tiny_streamed_setup()
    params = init_params(model, torch.Generator().manual_seed(0), "cuda")
    fn = functools.partial(safl_round, cfg, lambda p, b: loss_fn(model, p, b),
                           plan=make_packing_plan(cfg.sketch, params))
    key = prng.key(1)

    class Transient:
        def spec(self, t, base_key, device):
            codes = (OK, NAN, OK, OK, OK) if base_key == key and 2 <= t < 4 else (OK,) * 5
            return _spec_from_codes(torch.tensor(codes, dtype=torch.int32,
                                                 device=device), 1e3)

    devices = []

    def launch(p, s, *, key, start_round, on_chunk):
        def watch(t, p2, s2, h):
            devices.append((t, {v.device.type for v in p2.values()}))
            on_chunk(t, p2, s2, h)
        launches = cs.LAUNCHES.n
        out = run_scan(fn, sampler, p, s, rounds=6, key=key, chunk_size=2,
                       start_round=start_round, on_chunk=watch, faults=Transient())
        assert cs.LAUNCHES.n - launches == 6 - start_round
        return out

    p, s, _, log = run_supervised(launch, params, init_safl(cfg, params), rounds=6,
                                  key=key, config=SupervisorConfig(max_retries=2))
    assert [(e["retry"], e["t_resume"]) for e in log] == [(1, 2)]
    assert [t for t, _ in devices] == [2, 4, 4, 6]
    assert all(d == {"cuda"} for _, d in devices)
    assert all(v.is_cuda and bool(torch.isfinite(v).all()) for v in p.values())


def _smoke_batch(cfg, device, B=2, S=20):
    gen = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen)}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = torch.randn(
            (B, cfg.num_frontend_tokens, cfg.d_model), generator=gen) * 0.02
    if cfg.frontend == "audio":
        batch["audio_embeds"] = torch.randn(
            (B, cfg.encoder_seq, cfg.d_model), generator=gen) * 0.02
    return {k: v.to(device) for k, v in batch.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_family_loss_and_grads_on_card_match_cpu(arch):
    """Each architecture's SMOKE loss and gradients on the card against
    the CPU from the same weights (TF32 off): float32 matmul orders, the
    loss to 1e-5 relative, each gradient leaf to 1e-3 of its largest
    entry plus 1e-3 relative."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch, smoke=True)
    out = {}
    for dev in ("cpu", "cuda"):
        params = init_params(cfg, torch.Generator().manual_seed(0), dev)
        for p in params.values():
            p.requires_grad_(True)
        loss = loss_fn(cfg, params, _smoke_batch(cfg, dev))
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        out[dev] = (loss.item(), {k: None if g is None else g.cpu()
                                  for k, g in zip(params, grads)})
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-5)
    for k, want in out["cpu"][1].items():
        got = out["cuda"][1][k]
        if want is None:
            assert got is None, k
            continue
        torch.testing.assert_close(got, want, rtol=1e-3,
                                   atol=1e-3 * float(want.abs().max()) + 1e-12)


@pytest.mark.cuda
def test_hvp_on_card_matches_cpu():
    """The forward-over-reverse HVP of bert_100m SMOKE on the card
    against the CPU on the same vector: to 1e-4 of its largest entry plus
    1e-3 relative."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("bert_100m", smoke=True)
    hv, v = {}, None
    for dev in ("cpu", "cuda"):
        params = init_params(cfg, torch.Generator().manual_seed(0), dev)
        mv, d = make_hvp(lambda p, b: loss_fn(cfg, p, b, remat=False), params,
                         _smoke_batch(cfg, dev, S=32))
        if v is None:
            v = torch.randn(d, generator=torch.Generator().manual_seed(1))
        hv[dev] = mv(v.to(dev)).cpu()
    torch.testing.assert_close(hv["cuda"], hv["cpu"], rtol=1e-3,
                               atol=1e-4 * float(hv["cpu"].abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_on_card_matches_cpu(arch):
    """Each architecture's SMOKE decode, teacher-forced for 24 steps at
    max_seq 32 (h2o-danube's 16-slot ring wraps), on the card against the
    CPU from the same weights (TF32 off): every step's logits and the final
    caches within chip_smoke phase 3's tolerance (atol 2e-3, rtol 1e-3)."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.models import decode_step, init_cache
    from repro_torch.models.model import encode_for_decode
    cfg = get_config(arch, smoke=True)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 24), generator=gen)
    audio = torch.randn((2, cfg.encoder_seq, cfg.d_model), generator=gen) * 0.02
    out = {}
    for dev in ("cpu", "cuda"):
        params = init_params(cfg, torch.Generator().manual_seed(0), dev)
        cache = init_cache(cfg, 2, 32, dev)
        if cfg.encoder_layers:
            cache = encode_for_decode(cfg, params, cache, audio.to(dev))
        logits = []
        for t in range(24):
            lg, cache = decode_step(cfg, params, cache, tokens[:, t:t + 1].to(dev),
                                    torch.tensor(t, device=dev))
            logits.append(lg.cpu())
        out[dev] = torch.stack(logits), {k: v.cpu() for k, v in cache.items()}
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-3, atol=2e-3)
    for k, want in out["cpu"][1].items():
        torch.testing.assert_close(out["cuda"][1][k], want, rtol=1e-3, atol=2e-3)


@pytest.mark.cuda
def test_serve_example_on_card_matches_cpu():
    """``serve.example()`` from the same weights: each greedy token on the
    card equals the CPU's up to the first call whose top-2 margin on the
    CPU is within twice the logits' tolerance (2e-3)."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.launch import serve
    out = {dev: serve.example(dev, params=init_params(
        serve.EXAMPLE, torch.Generator().manual_seed(0), dev), keep_logits=True)
        for dev in ("cpu", "cuda")}
    lc, lg = out["cpu"]["all_logits"], out["cuda"]["all_logits"].cpu()
    top2 = lc.topk(2, dim=-1).values
    close = ((top2[..., 0] - top2[..., 1]) <= 4e-3).any(dim=-1)
    # calls before the first close one see the same tokens on both devices
    calls = int(close.float().argmax()) if bool(close.any()) else lc.shape[0]
    torch.testing.assert_close(lg[:calls + 1], lc[:calls + 1], rtol=1e-3, atol=2e-3)
    assert torch.equal(out["cuda"]["tokens"][:, :calls + 1].cpu(),
                       out["cpu"]["tokens"][:, :calls + 1])


def _two_ranks_on_the_card(mesh):
    """One rank of the (data 2, model 1) mesh on the card: three SAFL rounds
    through B1, scanned and host-looped; (B1 launches of this rank, losses,
    both trajectories bitwise equal on every rank)."""
    import torch.distributed as dist
    from repro_torch.launch import train as T
    from repro_torch.models.sharding import local_shard
    model = ModelConfig(name="tiny", arch_type="dense", num_layers=2, d_model=64,
                        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128)
    cfg = SAFLConfig(sketch=SketchConfig(kind="countsketch", ratio=0.05, min_b=16,
                                         cs_hash="independent", use_kernels=True),
                     server=AdaConfig(name="amsgrad", lr=0.01), client_lr=0.5,
                     local_steps=2)
    smp = T.mesh_sampler(mesh, BigramLMData(LMDataConfig(
        vocab_size=128, seq_len=16, num_clients=2, alpha=0.05)).device_sampler(4, 2))
    _, pspecs = T._mesh_pspecs(model, "cross_device")

    def fresh():
        p = local_shard(mesh, init_params(model, torch.Generator().manual_seed(0),
                                          mesh.device), pspecs)
        return p, init_safl(cfg, p)

    cs.LAUNCHES.n = 0
    p1, _, h1 = T.run_mesh_scan(model, cfg, mesh, smp, *fresh(), rounds=3,
                                key=prng.key(1))
    launches = cs.LAUNCHES.n
    step, _ = T.make_safl_train_step(model, cfg, mesh)
    p2, _, h2 = T.run_mesh_host_loop(step, smp, *fresh(), rounds=3, key=prng.key(1))
    same = torch.tensor([float(all(torch.equal(p1[k], p2[k]) for k in p1)
                               and (h1["loss"] == h2["loss"]).all())],
                        device=mesh.device)
    counts = torch.tensor([float(launches)], device=mesh.device)
    dist.all_reduce(same, op=dist.ReduceOp.MIN)
    dist.all_reduce(counts, op=dist.ReduceOp.MIN)
    return float(counts), h1["loss"], bool(same.item() == 1.0)


@pytest.mark.cuda
def test_mesh_two_ranks_on_the_card():
    """``launch.mesh.spawn`` of two ranks on the card (gloo when they share
    one card): B1 launched in every round on every rank, finite losses,
    the scanned driver bitwise its host loop."""
    _need_card()
    from repro_torch.launch.mesh import spawn
    fewest, losses, same = spawn(_two_ranks_on_the_card, (2, 1), ("data", "model"),
                                 device="cuda", timeout=300)
    assert fewest >= 3
    assert np.isfinite(losses).all() and losses.shape == (3,)
    assert same


def _guarded_ranks_on_the_card(mesh):
    """One rank of the (data 2, model 1) mesh on the card: two guarded SAFL
    rounds at G = 4 (two clients a rank), round 1 poisoning client 1 and
    scaling client 2 by 1e3, under the norm sentinel; (B1 launches of this
    rank at its G = 2 rows, the history, whether the params are finite on
    every rank)."""
    import torch.distributed as dist
    from repro_torch.fed import BYZANTINE, NAN, OK, FaultTable, SentinelConfig
    from repro_torch.launch import train as T
    from repro_torch.models.sharding import local_shard
    model = ModelConfig(name="tiny", arch_type="dense", num_layers=2, d_model=64,
                        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128)
    cfg = SAFLConfig(sketch=SketchConfig(kind="countsketch", ratio=0.05, min_b=16,
                                         cs_hash="independent", use_kernels=True),
                     server=AdaConfig(name="amsgrad", lr=0.01), client_lr=0.5,
                     local_steps=2)
    smp = T.mesh_sampler(mesh, BigramLMData(LMDataConfig(
        vocab_size=128, seq_len=16, num_clients=4, alpha=0.05)).device_sampler(4, 2))
    _, pspecs = T._mesh_pspecs(model, "cross_device")
    p = local_shard(mesh, init_params(model, torch.Generator().manual_seed(0),
                                      mesh.device), pspecs)
    cs.LAUNCHES.n = 0
    p, _, hist = T.run_mesh_scan(
        model, cfg, mesh, smp, p, init_safl(cfg, p), rounds=2, key=prng.key(1),
        faults=FaultTable(codes=((OK,) * 4, (OK, NAN, BYZANTINE, OK))),
        sentinel=SentinelConfig(norm_mult=3.0))
    finite = torch.tensor([float(all(bool(torch.isfinite(v).all())
                                     for v in p.values()))], device=mesh.device)
    dist.all_reduce(finite, op=dist.ReduceOp.MIN)
    return cs.LAUNCHES.n, hist, bool(finite.item() == 1.0)


@pytest.mark.cuda
def test_mesh_guarded_round_on_the_card():
    """Two ranks on the card under the guard: B1 once a round on each rank
    over its two clients' rows, the NaN and the Byzantine client rejected
    in round 1 (the sentinel's stats summed over both ranks), finite
    losses and params."""
    _need_card()
    from repro_torch.launch.mesh import spawn
    launches, hist, finite = spawn(_guarded_ranks_on_the_card, (2, 1),
                                   ("data", "model"), device="cuda", timeout=300)
    assert launches == 2
    assert hist["n_rejected"].tolist() == [0, 2]
    assert hist["diverged"].tolist() == [0.0, 0.0]
    assert np.isfinite(hist["loss"]).all() and finite
