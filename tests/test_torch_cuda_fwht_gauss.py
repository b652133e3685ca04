"""The FWHT (B2) and Gaussian (B3/B4) kernels on the card against their plain
versions, and their layouts and limits against the sources; the tests
marked ``cuda`` skip without a card (tests/test_torch_cuda.py holds the
helpers and the count-sketch, round, mesh and serving tests)."""

import pathlib

import pytest
import torch

from repro_torch.kernels import fwht as fw
from repro_torch.kernels import gaussian_sketch as gs

from test_torch_cuda import FWHT_CARD_SHAPES, _need_card


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
