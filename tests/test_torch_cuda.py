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


@pytest.mark.parametrize("log_c", range(25))
def test_fwht_plan_runs_every_stage_once_in_order(log_c):
    """The property behind B2's bit-for-bit equality: for every power-of-two
    row length up to ``MAX_N``, the passes and the levels inside them
    (registers, lanes, shared memory) run the stages h = 1 .. C/2 once each,
    in ascending order; and each pass's layout fits its kernel."""
    c = 1 << log_c
    n1, c1 = fw.split(c)
    assert n1 * c1 == c and c1 <= fw.MAX_C
    plan = fw.stage_bits(c)
    assert [b for _, _, bits in plan for b in bits] == list(range(log_c))
    assert [p for p, _, _ in plan] == ["rows"] * 3 + ["columns"] * 3 * (n1 > 1)
    if n1 == 1:
        return
    assert n1 >= fw.MIN_N1 and c1 >= 1024
    lay = fw.col_layout(n1.bit_length() - 1)
    assert 0 <= lay["WB"] <= lay["RB"] and lay["QB"] >= 0 and lay["LB"] + lay["QL"] == 5
    assert lay["QB"] - lay["QL"] + lay["WB"] == 3       # 8 warps of a block
    assert lay["TC"] * n1 == lay["TILE"] and 4 <= lay["TC"] <= c1
    assert fw.chunk_rows(c) * c * 4 <= fw.L2_CHUNK_BYTES or fw.chunk_rows(c) == 1


def test_fwht_limits_come_from_the_source():
    """The wrapper's limits and layout constants are the kernels' own, read
    from their source."""
    text = (pathlib.Path(fw.build.CSRC) / "fwht.cu").read_text()
    for name, value in (("FWHT_MAX_C", fw.MAX_C), ("FWHT_THREADS", fw.THREADS),
                        ("FWHT_ROW_ELEMS", fw.ROW_ELEMS), ("FWHT_COL_VECS", fw.COL_VECS),
                        ("FWHT_MIN_N1", fw.MIN_N1)):
        assert f"#define {name} {value} " in text
    assert fw.MAX_N == fw.MAX_C ** 2


@pytest.mark.parametrize("x,match", [
    (torch.zeros((2, 8), dtype=torch.float64), "x must be"),
    (torch.zeros(8), "x must be"),
    (torch.zeros((8, 4)).t(), "x must be"),
    (torch.zeros((2, 12)), "power of 2"),
    (torch.empty((1, 2 * fw.MAX_N), device="meta"), "power of 2"),
    (torch.zeros((2, 8)), "CUDA tensor")])
def test_fwht_cuda_checks_its_arguments(x, match):
    """B2 raises on what its kernels do not take, before anything reaches
    the card."""
    with pytest.raises(ValueError, match=match):
        fw.fwht_rows_cuda(x)


# B2 on the card: edge shapes, and each (R, C) group of an lm25m SRHT round
# (n2 = 512, 4096, 2^20, 2^21, 2^22) with small R
FWHT_CARD_SHAPES = [(1, 1), (1, 2), (3, 4), (5, 16), (3, 2048), (7, 8192), (33, 4096),
                    (2, 16384), (1, 1 << 24), (3, 512), (2, 4096), (2, 1 << 20),
                    (3, 1 << 21), (2, 1 << 22)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FWHT_CARD_SHAPES)
def test_fwht_bitwise_equals_plain(shape):
    """The kernels run the plain version's additions in its order: equal
    bit for bit, also for a view at an offset, and two calls alike."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(shape[0] + shape[1])
    x = torch.randn(shape, generator=gen, device="cuda")
    want = fw.fwht_plain(x)
    first = fw.fwht_rows_cuda(x)
    assert torch.equal(first, want)
    assert torch.equal(fw.fwht_rows_cuda(x), first)
    flat = torch.randn(x.numel() + 1, generator=gen, device="cuda")
    view = flat[1:].view(shape)
    assert torch.equal(fw.fwht_rows_cuda(view), fw.fwht_plain(view))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,calls,device_launches", [
    ((0, 64), 0, 0), ((3, 0), 0, 0),      # nothing to compute: no launch
    ((3, 4096), 1, 1), ((40, 8), 1, 1),  # one pass
    ((2, 1 << 22), 1, 2)])                # memset of the counters + the kernel
def test_fwht_counts_what_it_launches(shape, calls, device_launches):
    """``LAUNCHES`` counts calls that launched, ``DEVICE_LAUNCHES`` the
    kernels and memsets each call put on the stream."""
    _need_card()
    x = torch.randn(shape, device="cuda")
    fw.LAUNCHES.n = fw.DEVICE_LAUNCHES.n = 0
    fw.fwht_rows_cuda(x)
    assert (fw.LAUNCHES.n, fw.DEVICE_LAUNCHES.n) == (calls, device_launches)


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
def test_gaussian_kernels_match_plain_versions():
    """B3 (sk) and B4 (desk) against their plain versions at the
    reference's test shapes and the first 8 tiles of the lm25m plan's
    largest leaf (b = 70,779), plus adjointness.  The same R (integer
    counters, an ulp or two of log/cos); float32 sums in another order:
    1e-5 of the largest output."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    for n, b in [(100, 16), (513, 64), (2000, 128), (1500, 128), (900, 64),
                 (8 * gs.TILE_N, 70_779)]:
        x = torch.randn(n, generator=gen, device="cuda")
        s = torch.randn(b, generator=gen, device="cuda")
        sk, desk = gs.gaussian_sk_cuda(11, x, b), gs.gaussian_desk_cuda(11, s, n)
        for got, want in ((sk, gs.gaussian_sk_plain(11, x, b)),
                          (desk, gs.gaussian_desk_plain(11, s, n))):
            torch.testing.assert_close(got, want, rtol=1e-5,
                                       atol=1e-5 * float(want.abs().max()))
        lhs, rhs = float(sk @ s), float(x @ desk)
        assert abs(lhs - rhs) <= 1e-5 * float(sk.norm() * s.norm()), (n, b)


def test_gaussian_layout_comes_from_the_source():
    """The wrapper's tile and sk block layout are the kernels' own, read
    from their source."""
    text = (pathlib.Path(gs.build.CSRC) / "gaussian_sketch.cu").read_text()
    for name, value in (("TILE_N", gs.TILE_N), ("SK_THREADS", gs.SK_THREADS),
                        ("SK_COLS", gs.SK_COLS)):
        assert f"#define {name} {value}\n" in text


@pytest.mark.parametrize("n,b,slots", [
    (884_736, 17_695, 264), (884_736, 17_695, 396), (3_538_944, 70_779, 396),
    (4096, 70_779, 396), (100, 16, 396), (513, 64, 132), (1, 1, 264),
    (70_000_000, 3, 528), (3_000_000, 16_000_000, 264)])
def test_gaussian_sk_splits_cover_the_tiles(n, b, slots):
    """Every split of the sk grid is a non-empty run of whole tiles, the
    runs cover the tiles once in order and differ by at most one tile, and
    the grid fills one to four waves of the card's slots, or takes every
    tile, or is one split whose column blocks alone fill four waves."""
    splits = gs._sk_splits(n, b, slots)
    n_tiles = -(-n // gs.TILE_N)
    runs = [(n_tiles * y // splits, n_tiles * (y + 1) // splits) for y in range(splits)]
    assert runs[0][0] == 0 and runs[-1][1] == n_tiles
    assert all(a[1] == c[0] for a, c in zip(runs, runs[1:]))
    sizes = {t1 - t0 for t0, t1 in runs}
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    col_blocks = -(-b // (gs.SK_THREADS * gs.SK_COLS))
    assert splits == n_tiles or col_blocks * splits <= 4 * slots or (
        splits == 1 and col_blocks > 4 * slots)


@pytest.mark.cuda
@pytest.mark.parametrize("n,b", [(200_000, 3_000), (8 * gs.TILE_N, 70_779)])
def test_gaussian_two_calls_bitwise_equal(n, b):
    """B3 and B4 sum in a fixed order, with no float atomics: two calls on
    the same inputs return the same bits."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(n + b)
    x = torch.randn(n, generator=gen, device="cuda")
    s = torch.randn(b, generator=gen, device="cuda")
    assert torch.equal(gs.gaussian_sk_cuda(5, x, b), gs.gaussian_sk_cuda(5, x, b))
    assert torch.equal(gs.gaussian_desk_cuda(5, s, n), gs.gaussian_desk_cuda(5, s, n))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 511, 513])
@pytest.mark.parametrize("b", [1, 3, 255, 257])
def test_gaussian_edge_shapes_match_plain(n, b):
    """Ragged tiles (n = 1, 511, 513), ragged column blocks and columns of a
    thread (b = 1, 3, 255, 257, not multiples of 4) and an empty input,
    against the plain versions at the tolerance of
    ``test_gaussian_kernels_match_plain_versions``; x and s start off the
    16-byte alignment the kernels read them at."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(7 * n + b)
    x = torch.randn(n + 1, generator=gen, device="cuda")[1:]
    s = torch.randn(b + 1, generator=gen, device="cuda")[1:]
    sk, desk = gs.gaussian_sk_cuda(11, x, b), gs.gaussian_desk_cuda(11, s, n)
    assert sk.shape == (b,) and desk.shape == (n,)
    pairs = [(sk, gs.gaussian_sk_plain(11, x, b))]
    if n:     # the plain desk takes n >= 1
        pairs.append((desk, gs.gaussian_desk_plain(11, s, n)))
    for got, want in pairs:
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))


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
        mv, d = make_hvp(lambda p, b: loss_fn(cfg, p, b), params,
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
