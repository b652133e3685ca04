"""The port's mesh hooks held to the port itself, bit for bit.

One ``launch.mesh.spawn`` of four gloo ranks on the CPU, (data 2, model 2)
in ``cross_device``, tests/test_torch_mesh_round.py's one-layer model,
three rounds a run:

* ``microbatch`` >= G_loc is the materialized round (G = 4, two clients a
  rank);
* a ``delay="zero"`` ring under an all-ones mask is the hookless round,
  params and AMSGrad state, and a neutral fault policy is too (G = 2, one
  client a rank, as the reference pins them);
* a NaN payload the sentinel rejects equals the same client dropped, with
  and without the ring (G = 4);
* the scanned driver equals its host loop under the guard and under the
  ring (G = 4);
* ``stream=``: rank 0 writes the shards, which hold the unstreamed run's
  history, the other ranks write nothing, and every rank returns ``{}``.

Then every hook combination the reference refuses, with its exception
type (tests/test_mesh_scan.py :296, :366, :576, :595, :756), on a mesh
layout with no process started.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import prng
from repro_torch.core.adaptive import AdaConfig
from repro_torch.core.safl import SAFLConfig, init_safl
from repro_torch.core.sketch import SketchConfig
from repro_torch.data.synthetic import BigramLMData, LMDataConfig
from repro_torch.fed import (DROP, NAN, OK, AsyncConfig, CodecConfig,
                             FaultConfig, FaultTable, FullParticipation,
                             ImportanceParticipation, SentinelConfig,
                             UniformParticipation)
from repro_torch.launch import train as T
from repro_torch.launch.mesh import Mesh, spawn
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_params
from repro_torch.models.sharding import local_shard
from repro_torch.obs.shards import ShardWriter
from repro_torch.obs.telemetry import Telemetry

from torch_priority import lower_priority  # noqa: F401 (autouse)

MODEL = ModelConfig(name="meshscan", arch_type="dense", num_layers=1, d_model=32,
                    num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=64)
GRID = ((2, 2), ("data", "model"))
ROUNDS, KEY = 3, 7
STAGGER = AsyncConfig(max_delay=2, delay="stagger", staleness_alpha=0.5)
SENT = SentinelConfig(norm_mult=10.0)
PINS = ("microbatch_ge_gloc_is_materialized", "delay0_ring_is_hookless",
        "neutral_faults_are_hookless", "nan_equals_drop",
        "ring_nan_equals_drop", "guard_scan_equals_host_loop",
        "ring_scan_equals_host_loop", "stream_rank0_writes_the_history")


def _cfg(kind: str = "countsketch") -> SAFLConfig:
    return SAFLConfig(sketch=SketchConfig(kind=kind, ratio=0.05, min_b=16),
                      server=AdaConfig(name="amsgrad", lr=0.01), client_lr=0.5,
                      local_steps=2, remat_local=False)


def _row(code, G: int, client: int = 1) -> tuple:
    return tuple(code if c == client else OK for c in range(G))


def _same(a, b) -> bool:
    """Bitwise equality of two nested trees of tensors or arrays."""
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return bool(np.array_equal(np.asarray(a), np.asarray(b)))


def _all_ranks(ok: bool) -> bool:
    flag = torch.tensor([1.0 if ok else 0.0])
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item() == 1.0)


def _pin_ranks(mesh, tmp: str):
    os.nice(10)
    cfg = _cfg()
    key = prng.key(KEY)
    _, pspecs = T._mesh_pspecs(MODEL, "cross_device")
    full = init_params(MODEL, torch.Generator().manual_seed(0), "cpu")

    def sampler(G):
        return T.mesh_sampler(mesh, BigramLMData(LMDataConfig(
            vocab_size=MODEL.vocab_size, seq_len=16, num_clients=G,
            alpha=0.05)).device_sampler(8, 2))

    def fresh(acfg=None, G=2):
        p = local_shard(mesh, full, pspecs)
        if acfg is None:
            return p, init_safl(cfg, p)
        return p, T.init_mesh_async_state(MODEL, cfg, acfg, mesh, p,
                                          num_clients=G)

    def scan(G, acfg=None, **kw):
        return T.run_mesh_scan(MODEL, cfg, mesh, sampler(G), *fresh(acfg, G),
                               rounds=ROUNDS, key=key, buffer=acfg, **kw)

    def host_loop(G, acfg=None, faults=None, sentinel=None):
        step, _ = T.make_safl_train_step(MODEL, cfg, mesh, buffer=acfg,
                                         faults=faults, sentinel=sentinel,
                                         num_clients=G)
        return T.run_mesh_host_loop(step, sampler(G), *fresh(acfg, G),
                                    rounds=ROUNDS, key=key, buffer=acfg,
                                    faults=faults, sentinel=sentinel)

    pins = {}
    base4 = scan(4)
    pins["microbatch_ge_gloc_is_materialized"] = (
        _same(scan(4, microbatch=2), base4) and _same(scan(4, microbatch=64), base4))

    base2 = scan(2)
    p, s, h = scan(2, acfg=AsyncConfig(max_delay=0, delay="zero"),
                   participation=FullParticipation(2))
    pins["delay0_ring_is_hookless"] = _same(
        (p, s["opt"], h["loss"]), (base2[0], base2[1], base2[2]["loss"]))
    p, s, h = scan(2, faults=FaultConfig(num_clients=2))
    pins["neutral_faults_are_hookless"] = (
        _same((p, s, h["loss"]), (base2[0], base2[1], base2[2]["loss"]))
        and float(h["n_dropped"].sum()) == 0.0)

    nan, drop = (FaultTable(codes=(_row(c, 4),) * 2) for c in (NAN, DROP))
    ok = True
    for acfg in (None, STAGGER):
        p1, s1, h1 = scan(4, acfg, faults=nan, sentinel=SENT)
        p2, s2, h2 = scan(4, acfg, faults=drop, sentinel=SENT)
        s1, s2 = (s1, s2) if acfg is None else (s1["opt"], s2["opt"])
        ok = (_same((p1, s1, h1["loss"]), (p2, s2, h2["loss"]))
              and int(h1["n_rejected"].sum()) == 2
              and float(h2["n_dropped"].sum()) == 2.0
              and all(bool(torch.isfinite(x).all()) for x in p1.values()))
        pins["nan_equals_drop" if acfg is None else "ring_nan_equals_drop"] = ok

    guard = dict(faults=FaultTable(codes=((OK,) * 4, (OK, NAN, OK, DROP))),
                 sentinel=SENT)
    pins["guard_scan_equals_host_loop"] = _same(scan(4, **guard),
                                                host_loop(4, **guard))
    pins["ring_scan_equals_host_loop"] = _same(scan(4, STAGGER),
                                               host_loop(4, STAGGER))

    tel = Telemetry()
    p0, s0, h0 = scan(4, telemetry=tel, chunk_size=2)
    out_dir = os.path.join(tmp, f"rank{mesh.rank}")
    p, s, h = scan(4, telemetry=tel, chunk_size=2, stream=ShardWriter(out_dir))
    rows = []
    for path in sorted(glob.glob(os.path.join(out_dir, "metrics-*.jsonl"))):
        with open(path) as f:
            rows += [json.loads(line) for line in f]
    if mesh.rank == 0:
        wrote = ([r["t"] for r in rows] == list(range(ROUNDS))
                 and all(r[k] == float(h0[k][i]) for i, r in enumerate(rows)
                         for k in h0)
                 and all(set(r) - {"kind", "t"} == set(h0) for r in rows)
                 and os.path.exists(os.path.join(out_dir, "events.jsonl")))
    else:
        wrote = os.listdir(out_dir) == []
    pins["stream_rank0_writes_the_history"] = (
        wrote and h == {} and _same((p, s), (p0, s0)))
    return {k: _all_ranks(v) for k, v in pins.items()}


@pytest.fixture(scope="module")
def pins(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_hook_pins")
    return spawn(_pin_ranks, *GRID, str(tmp), device="cpu", timeout=300)


@pytest.mark.parametrize("pin", PINS)
def test_mesh_hook_pins_bitwise(pins, pin):
    assert pins[pin]


# ---------------------------------------------------------------------------
# the combinations the reference refuses, at build time (no process)
# ---------------------------------------------------------------------------

SILO = Mesh((2, 2, 1), ("pod", "data", "model"))


def _core(cfg=None, **hooks):
    return T._make_round_core(MODEL, cfg or _cfg(), SILO, "cross_silo", **hooks)


def test_mesh_microbatch_combinations_raise():
    """The streamed fold folds the payload before any client row exists
    (tests/test_mesh_scan.py :296)."""
    with pytest.raises(NotImplementedError, match="microbatch"):
        _core(buffer=AsyncConfig(), microbatch=1)
    with pytest.raises(NotImplementedError, match="microbatch"):
        _core(sentinel=SentinelConfig(norm_mult=0.0), microbatch=1)
    with pytest.raises(ValueError, match="sketch"):
        _core(T._fedopt_cfg(_cfg()), microbatch=1)
    with pytest.raises(ValueError, match="positive"):
        _core(microbatch=0)


def test_mesh_codec_combinations_raise():
    """The codec quantizes shard-local partial sums (:366)."""
    codec = CodecConfig(bits=8, error_feedback=False)
    with pytest.raises(NotImplementedError, match="codec"):
        _core(buffer=AsyncConfig(), codec=codec)
    with pytest.raises(NotImplementedError, match="codec"):
        _core(sentinel=SentinelConfig(norm_mult=0.0), codec=codec)
    with pytest.raises(ValueError, match="telemetry"):
        _core(telemetry=Telemetry(), codec=codec)
    with pytest.raises(ValueError, match="no sketch payload"):
        _core(T._fedopt_cfg(_cfg()), codec=codec)
    with pytest.raises(ValueError, match="error feedback"):
        _core(codec=CodecConfig(bits=8))


def test_mesh_buffer_combinations_raise():
    """The ring stores 0/1 cohorts in sketch space (:576, :595): a weighted
    mask raises ``TypeError`` at the round, FedOPT and a policy of the
    wrong client count at build time."""
    imp = ImportanceParticipation(2, probs=(0.5, 0.5), frac=0.5, seed=3)
    with pytest.raises(TypeError, match="weighted.*masks"):
        T.sharded_sketch_buffered(SILO, AsyncConfig(), None, {}, None, None,
                                  prng.key(0), prng.key(0), 0, "cross_silo",
                                  part_mask=imp.mask(0, "cpu"))
    with pytest.raises(ValueError, match="sketch space"):
        _core(T._fedopt_cfg(_cfg()), buffer=AsyncConfig(max_delay=1))
    with pytest.raises(ValueError, match="num_clients"):
        _core(participation=UniformParticipation(16, frac=0.5))
    with pytest.raises(ValueError, match="packed"):
        T.init_mesh_async_state(MODEL, T._fedopt_cfg(_cfg()), AsyncConfig(),
                                SILO, {}, "cross_silo")


def test_mesh_fault_combinations_raise():
    """Faults and sentinels act on the sketch payload, over the round's
    clients (:756)."""
    with pytest.raises(ValueError, match="sketch"):
        _core(_cfg("none"), faults=FaultConfig(num_clients=2))
    with pytest.raises(ValueError, match="clients"):
        _core(faults=FaultConfig(num_clients=16))
    with pytest.raises(ValueError, match="clients"):
        _core(num_clients=3)
