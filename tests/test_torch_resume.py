"""Schedules, checkpoints and resume in the port.

* ``optim.schedules`` against ``repro.optim.schedules`` for rounds 0..100
  (rtol 1e-6: the same float32 operations, ``cos``/``sqrt`` from two
  libraries).
* ``save_checkpoint``/``restore_checkpoint`` in the reference's format:
  a file written by either package restores in the other, arrays
  byte-equal.
* Resume, the three cases of tests/test_resume.py on the port's own
  ``run_scan``, two baselines' state (topk_ef's per-client error
  memories, FetchSGD's sketch-space momentum and error) and an async run
  with its staleness ring and the codec's EF memory, bit for bit: every
  per-round stream (the sampler's tokens, the cohort mask, the round key,
  ``kwargs_fn``, the delays and the rounding uniforms) is a pure function
  of the absolute round index, so restoring ``(params, opt, cursor)`` and
  re-entering the driver at ``start_round`` replays the uninterrupted run.
"""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as r_restore
from repro.checkpoint import save_checkpoint as r_save
from repro.optim import schedules as rsched
from repro_torch import prng
from repro_torch.checkpoint.io import restore_checkpoint, save_checkpoint
from repro_torch.core.adaptive import AdaConfig
from repro_torch.core.baselines import (BaselineConfig, baseline_round,
                                        init_baseline_state)
from repro_torch.core.packed import make_packing_plan
from repro_torch.core.safl import init_safl, safl_round
from repro_torch.core.sketch import SketchConfig
from repro_torch.fed import (AsyncConfig, CodecConfig, UniformParticipation,
                             init_async_state, make_async_round)
from repro_torch.launch.driver import run_host_loop, run_scan
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_params, loss_fn
from repro_torch.optim import schedules as tsched
from test_torch_safl import DATA, QUICK_KW, _cfgs, _samplers
from torch_priority import lower_priority  # noqa: F401 (autouse)

torch.set_num_threads(2)

SCHEDULES = {
    "constant": ((), {}),
    "inv_sqrt": ((), {}),
    "inv_sqrt_t0_5": ((), {"t0": 5.0}),
    "cosine": ((60,), {}),
    "cosine_warmup": ((100,), {"min_frac": 0.1, "warmup": 10}),
    "cosine_short": ((6,), {}),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_reference(name):
    args, kw = SCHEDULES[name]
    fn = name.split("_t0")[0].split("_warmup")[0].split("_short")[0]
    want = np.asarray(getattr(rsched, fn)(*args, **kw)(jnp.arange(101)))
    got = np.array([getattr(tsched, fn)(*args, **kw)(t) for t in range(101)],
                   np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_sketch_size_schedule_matches_reference():
    want = rsched.sketch_size_schedule(0.05, 40, final_frac=0.2)
    got = tsched.sketch_size_schedule(0.05, 40, final_frac=0.2)
    assert [got(t) for t in range(-2, 45)] == [want(t) for t in range(-2, 45)]


# ---------------------------------------------------------------------------
# checkpoints across packages
# ---------------------------------------------------------------------------

def _tree_arrays(seed):
    """Leaves of every dtype a run's checkpoint holds (float32 weights and
    moments, the int32 step, the cursor's int32 round and uint32 key) and a
    bfloat16 leaf, which both packages store widened to float32."""
    rng = np.random.RandomState(seed)
    return {"params": {"embed": rng.randn(6, 4).astype(np.float32),
                       "layers": {"l0": {"w": rng.randn(2, 3, 3).astype(np.float32)}}},
            "opt": {"step": np.asarray(3, np.int32),
                    "m": {"embed": rng.randn(6, 4).astype(np.float32)}},
            "cursor": {"t": np.asarray(4, np.int32),
                       "key": np.asarray([0, 2**32 - 5], np.uint32)},
            "half": rng.randn(5).astype(ml_dtypes.bfloat16)}


def _port_tree(tree):
    """The port's form of a checkpoint tree: leaves keyed by "/"-joined paths
    under each top-level entry, as the port's params and moments are."""
    def flat(node, prefix=""):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}/"))
            else:
                out[f"{prefix}{k}"] = v
        return out

    def tensor(v):
        if v.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(v))

    return {k: {p: tensor(v) for p, v in flat(node).items()}
            if isinstance(node, dict) else tensor(node) for k, node in tree.items()}


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _as_numpy(v):
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32).numpy() if v.dtype == torch.bfloat16 else v.numpy()
    v = np.asarray(v)
    return v.astype(np.float32) if v.dtype == ml_dtypes.bfloat16 else v


def _assert_same_leaves(got, want):
    got, want = _leaves(got), _leaves(want)
    assert set(got) == set(want)
    for k in want:
        a, b = _as_numpy(got[k]), _as_numpy(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


def test_port_checkpoint_restores_in_reference(tmp_path):
    arrays = _tree_arrays(0)
    path = str(tmp_path / "sub" / "port")
    save_checkpoint(path, _port_tree(arrays), step=4)
    like = jax.tree.map(lambda v: jnp.zeros(v.shape, v.dtype), _tree_arrays(1))
    tree, step = r_restore(path, like)
    assert step == 4
    _assert_same_leaves(tree, arrays)
    assert sorted(p.name for p in (tmp_path / "sub").iterdir()) == ["port.json",
                                                                     "port.npz"]


def test_reference_checkpoint_restores_in_port(tmp_path):
    arrays = _tree_arrays(2)
    path = str(tmp_path / "ref")
    r_save(path, jax.tree.map(jnp.asarray, arrays), step=9)
    tree, step = restore_checkpoint(path, _port_tree(_tree_arrays(3)))
    assert step == 9
    _assert_same_leaves(tree, _port_tree(arrays))
    with pytest.raises(KeyError, match="missing leaf"):
        restore_checkpoint(path, {"nope": torch.zeros(1)})
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(path, {"half": torch.zeros(4)})


# ---------------------------------------------------------------------------
# resume on the port's own driver
# ---------------------------------------------------------------------------

MODEL = ModelConfig(**QUICK_KW)


def _setup():
    tcfg = _cfgs(kind="countsketch", cs_hash="independent")[1]
    _, smp = _samplers({**DATA, "vocab_size": 128, "seq_len": 16}, 2)
    params = lambda: init_params(MODEL, torch.Generator().manual_seed(0), "cpu")
    round_fn = functools.partial(safl_round, tcfg, lambda p, b: loss_fn(MODEL, p, b),
                                 plan=make_packing_plan(tcfg.sketch, params()))
    return round_fn, smp, lambda: (params(), init_safl(tcfg, params()))


def _cursor_state(params, opt, t, key):
    return {"params": params, "opt": opt,
            "cursor": {"t": torch.tensor(t),
                       "key": torch.tensor(key, dtype=torch.uint32)}}


def _restore(path, fresh):
    state, step = restore_checkpoint(path, _cursor_state(*fresh(), 0, (0, 0)))
    key = tuple(int(k) for k in state["cursor"]["key"].tolist())
    return state, step, key


def _assert_trees_equal(a, b):
    a, b = _leaves(a), _leaves(b)
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_resume_from_chunk_boundary_is_bit_identical(tmp_path):
    """Stop after the chunk that ends at round 4, restore the (t, key)
    cursor and resume: params, opt state and the stitched loss history
    equal the uninterrupted 6-round run's; the host loop resumes alike."""
    round_fn, smp, fresh = _setup()
    key = prng.fold_in(prng.key(3), 99)
    ckpt = str(tmp_path / "ck")
    p_ref, s_ref, h_ref = run_scan(round_fn, smp, *fresh(), rounds=6, key=key,
                                   chunk_size=2)

    def on_chunk(t_done, p, s, hist):
        save_checkpoint(ckpt, _cursor_state(p, s, t_done, key), step=t_done)

    _, _, h_a = run_scan(round_fn, smp, *fresh(), rounds=4, key=key,
                         chunk_size=2, on_chunk=on_chunk)
    state, step, k2 = _restore(ckpt, fresh)
    assert step == 4 and int(state["cursor"]["t"]) == 4 and k2 == key
    p_b, s_b, h_b = run_scan(round_fn, smp, state["params"], state["opt"],
                             rounds=6, key=k2, chunk_size=2,
                             start_round=int(state["cursor"]["t"]))
    assert h_b["loss"].shape == (2,)
    np.testing.assert_array_equal(np.concatenate([h_a["loss"], h_b["loss"]]),
                                  h_ref["loss"])
    _assert_trees_equal(p_b, p_ref)
    _assert_trees_equal(s_b, s_ref)
    p_c, s_c, h_c = run_host_loop(round_fn, smp, state["params"], state["opt"],
                                  rounds=6, key=k2, start_round=4)
    np.testing.assert_array_equal(h_c["loss"], h_ref["loss"][4:])
    _assert_trees_equal(p_c, p_ref)
    assert run_scan(round_fn, smp, p_c, s_c, rounds=6, key=k2,
                    start_round=6)[2] == {}


def test_resume_is_chunk_split_invariant(tmp_path):
    """Resuming at round 4 with chunks of 3 (a tail chunk of 2 follows the
    full one of 3 at 7 rounds) lands on the 7-round run in one chunk."""
    round_fn, smp, fresh = _setup()
    key = prng.key(8)
    ckpt = str(tmp_path / "ck2")
    p_ref, s_ref, h_ref = run_scan(round_fn, smp, *fresh(), rounds=7, key=key)
    p4, s4, _ = run_scan(round_fn, smp, *fresh(), rounds=4, key=key, chunk_size=4)
    save_checkpoint(ckpt, _cursor_state(p4, s4, 4, key), step=4)
    state, _, k2 = _restore(ckpt, fresh)
    p_b, s_b, h_b = run_scan(round_fn, smp, state["params"], state["opt"],
                             rounds=7, key=k2, chunk_size=3,
                             start_round=int(state["cursor"]["t"]))
    assert h_b["loss"].shape == (3,)
    np.testing.assert_array_equal(h_b["loss"], h_ref["loss"][4:])
    _assert_trees_equal(p_b, p_ref)
    _assert_trees_equal(s_b, s_ref)


def test_resume_with_participation_and_lr_schedule(tmp_path):
    """Cohort masks and ``kwargs_fn`` are pure in the absolute round: a run
    resumed under partial participation and a cosine server LR replays the
    uninterrupted one, uplink bits included."""
    round_fn, smp, fresh = _setup()
    key = prng.key(5)
    pol = UniformParticipation(5, frac=0.4, seed=2)
    sched = tsched.cosine(6)
    kwargs_fn = lambda t: {"lr_scale": sched(t)}
    ckpt = str(tmp_path / "ck3")
    run = functools.partial(run_scan, round_fn, smp, key=key, participation=pol,
                            kwargs_fn=kwargs_fn, bits_per_round=1000)
    p_ref, s_ref, h_ref = run(*fresh(), rounds=6)
    p3, s3, _ = run(*fresh(), rounds=3)
    save_checkpoint(ckpt, _cursor_state(p3, s3, 3, key), step=3)
    state, _, k2 = _restore(ckpt, fresh)
    assert k2 == key
    p_b, s_b, h_b = run(state["params"], state["opt"], rounds=6, chunk_size=2,
                        start_round=int(state["cursor"]["t"]))
    np.testing.assert_array_equal(h_ref["uplink_bits"], [2000.0] * 6)
    for k in ("loss", "uplink_bits"):
        np.testing.assert_array_equal(h_b[k], h_ref[k][3:])
    _assert_trees_equal(p_b, p_ref)
    _assert_trees_equal(s_b, s_ref)
    # the schedule really reached the server: another one changes the run
    p_c, _, _ = run_scan(round_fn, smp, *fresh(), rounds=6, key=key,
                         participation=pol)
    assert any(not torch.equal(p_c[k], p_ref[k]) for k in p_ref)


@pytest.mark.parametrize("name", ["topk_ef", "fetchsgd"])
def test_baseline_resume_is_bit_identical(tmp_path, name):
    """A baseline's state, its int32 ``round`` included, checkpointed after
    round 2 of 4 and restored: the resumed rounds equal the uninterrupted
    run's, parameters, state and losses."""
    sketch = SketchConfig(kind="countsketch", ratio=0.05, min_b=8,
                          cs_hash="independent", use_kernels=True)
    cfg = BaselineConfig(name=name, client_lr=0.5, local_steps=2,
                         server=AdaConfig(name="sgd", lr=1.0), topk_ratio=0.05,
                         sketch=sketch)
    _, smp = _samplers({**DATA, "vocab_size": 128, "seq_len": 16}, 2)
    params = lambda: init_params(MODEL, torch.Generator().manual_seed(0), "cpu")
    plan = make_packing_plan(sketch, params())
    round_fn = functools.partial(baseline_round, cfg, lambda p, b: loss_fn(MODEL, p, b),
                                 plan=plan)
    fresh = lambda: (params(), init_baseline_state(cfg, params(), 5, plan=plan))
    key = prng.key(11)
    ckpt = str(tmp_path / "ck4")
    p_ref, s_ref, h_ref = run_scan(round_fn, smp, *fresh(), rounds=4, key=key)

    def on_chunk(t_done, p, s, hist):
        if t_done == 2:
            save_checkpoint(ckpt, _cursor_state(p, s, t_done, key), step=t_done)

    _, _, h_a = run_scan(round_fn, smp, *fresh(), rounds=2, key=key,
                         chunk_size=1, on_chunk=on_chunk)
    state, step, k2 = _restore(ckpt, fresh)
    assert step == 2 and int(state["opt"]["round"]) == 2 and k2 == key
    p_b, s_b, h_b = run_scan(round_fn, smp, state["params"], state["opt"],
                             rounds=4, key=k2, start_round=2)
    np.testing.assert_array_equal(np.concatenate([h_a["loss"], h_b["loss"]]),
                                  h_ref["loss"])
    _assert_trees_equal(p_b, p_ref)
    _assert_trees_equal(s_b, s_ref)


def test_async_ring_and_codec_memory_resume_is_bit_identical(tmp_path):
    """An async SAFL run (stagger delays, so the ring holds payloads that
    have not arrived yet) with the int8 codec's EF memory, staged through
    ``microbatch=2``: the state, the ring and the EF memory included,
    checkpointed after round 3 of 5 and restored, the resumed rounds equal
    the uninterrupted run's, params, state and history."""
    tcfg = _cfgs(kind="countsketch", cs_hash="independent")[1]
    _, smp = _samplers({**DATA, "vocab_size": 128, "seq_len": 16}, 2)
    params = lambda: init_params(MODEL, torch.Generator().manual_seed(0), "cpu")
    plan = make_packing_plan(tcfg.sketch, params())
    acfg, codec = AsyncConfig(max_delay=2, delay="stagger"), CodecConfig(bits=8)
    round_fn = make_async_round(tcfg, lambda p, b: loss_fn(MODEL, p, b), acfg, plan,
                                codec=codec)
    fresh = lambda: (params(), init_async_state(tcfg, acfg, params(), plan, 5,
                                                codec=codec))
    key = prng.key(13)
    ckpt = str(tmp_path / "ck5")
    run = functools.partial(run_scan, round_fn, smp, key=key, buffer=True,
                            microbatch=2, bits_per_round=1)
    p_ref, s_ref, h_ref = run(*fresh(), rounds=5)

    def on_chunk(t_done, p, s, hist):
        if t_done == 3:
            save_checkpoint(ckpt, _cursor_state(p, s, t_done, key), step=t_done)

    _, s_a, h_a = run(*fresh(), rounds=3, chunk_size=1, on_chunk=on_chunk)
    assert s_a["buf"].abs().sum() > 0 and s_a["ef"].abs().sum() > 0
    state, step, k2 = _restore(ckpt, fresh)
    assert step == 3 and k2 == key
    p_b, s_b, h_b = run(state["params"], state["opt"], rounds=5, start_round=3)
    assert set(h_ref) == {"loss", "uplink_bits", "arrival_weight"}
    for k in h_ref:
        np.testing.assert_array_equal(np.concatenate([h_a[k], h_b[k]]), h_ref[k])
    _assert_trees_equal(p_b, p_ref)
    _assert_trees_equal(s_b, s_ref)
