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

import pytest
import torch

from repro_torch import prng
from repro_torch.core.adaptive import AdaConfig
from repro_torch.core.packed import make_packing_plan
from repro_torch.core.safl import SAFLConfig, init_safl, safl_round
from repro_torch.core.sketch import SketchConfig
from repro_torch.data.synthetic import BigramLMData, LMDataConfig
from repro_torch.kernels import countsketch as cs
from repro_torch.kernels import fwht as fw
from repro_torch.kernels import gaussian_sketch as gs
from repro_torch.launch.driver import run_host_loop, run_scan
from repro_torch.models.config import ModelConfig
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
