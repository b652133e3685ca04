"""Attention on a model axis that cuts heads, on four gloo CPU ranks against
the reference.

On (data 1, model 4) a rank's q or k/v columns of these SMOKE configs are
not whole heads, which GSPMD reshards and ``models/parallel.py`` handles
with ``head_plan``: llama3.2-1b and h2o-danube (sliding window) have 4
query and 2 key/value heads, so the key/value heads split; qwen2-7b at 6
query and 2 key/value heads of 32 (q/k/v biases) and whisper at 6 and 6
(the encoder, cross-attention) split their query heads too; qwen2-7b at 10
and 5 heads of 16 gives a rank query heads that read its kv heads
unevenly (one kv head a query head), and llama3.2-1b at 2 and 1 heads of
64 leaves two ranks no query head.  Each case's prefill (default layout
and FSDP) against the reference's jitted ``make_prefill_step``, and its
sharded loss and gradients (``launch.train.sharded_value_and_grad`` in
``cross_device``) against the reference's one-process
``jax.value_and_grad(loss_fn)``, from the same numpy weights, at rtol
1e-4 / atol 1e-5 (``test_torch_serve_mesh.py``'s and
``test_torch_parallel_grad.py``'s).  The collective calls of each step
(counted by ``launch.op_costs.OpCosts``): one all_gather an attention
call where only the kv heads split, two where the query heads split, and
as many reduce-scatters in the backward.  And ``head_plan`` itself: every
head computed once, at most ceil(H / n) a rank, each query head's kv head
the reference's, nothing gathered where heads divide.

ONE ``launch.mesh.spawn`` of four ranks runs every case while the
reference runs in a thread of the parent; no jax at the top (the ranks
import this module by name).
"""

import concurrent.futures
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.io import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.launch import train as T
from repro_torch.launch.mesh import spawn
from repro_torch.launch.op_costs import OpCosts
from repro_torch.models.parallel import head_plan
from repro_torch.models.sharding import gather_tree, local_shard
from test_torch_parallel_grad import model_inputs
from test_torch_parallel_grad import reference as grad_reference
from test_torch_serve_mesh import B, inputs
from test_torch_serve_mesh import reference as serve_reference

from torch_priority import lower_priority  # noqa: F401 (autouse)

GRID = ((1, 4), ("data", "model"))
TOL = dict(rtol=1e-4, atol=1e-5)
# (case, arch, overrides)
CASES = (("llama3_2_1b", "llama3_2_1b", {}),
         ("h2o_danube_1_8b", "h2o_danube_1_8b", {}),
         ("qwen2_7b/q_split", "qwen2_7b", dict(num_heads=6, num_kv_heads=2, head_dim=32)),
         ("whisper_large_v3/q_split", "whisper_large_v3",
          dict(num_heads=6, num_kv_heads=6, head_dim=32)),
         ("qwen2_7b/uneven_kv", "qwen2_7b", dict(num_heads=10, num_kv_heads=5, head_dim=16)),
         ("llama3_2_1b/no_heads", "llama3_2_1b",
          dict(num_heads=2, num_kv_heads=1, head_dim=64)))
NAMES = [c[0] for c in CASES]
# (num_heads, num_kv_heads, head_dim, ranks): the production mesh's 16-way
# model axis for the eight archs that split there, qwen2-7b over 8, the
# SMOKE cases over 4
PLANS = ((20, 20, 64, 16), (64, 8, 128, 16), (28, 4, 128, 16), (32, 8, 64, 16),
         (20, 20, 128, 16), (48, 8, 128, 16), (28, 4, 128, 8), (4, 2, 64, 4),
         (6, 2, 32, 4), (6, 6, 32, 4), (10, 5, 16, 4), (2, 1, 64, 4), (12, 3, 8, 8))


def case_config(arch: str, overrides: dict):
    return dataclasses.replace(get_config(arch, smoke=True), **overrides)


def heads_cfg(H: int, Hk: int, hd: int):
    return dataclasses.replace(get_config("llama3_2_1b", smoke=True), num_heads=H,
                               num_kv_heads=Hk, head_dim=hd)


def expected_gathers(cfg, n: int) -> int:
    """The all_gathers of a forward: per attention call, one where only
    the kv columns are part heads, two where the query columns are."""
    per = (2 if cfg.num_heads * cfg.hd // n % cfg.hd
           else 1 if cfg.num_kv_heads * cfg.hd // n % cfg.hd else 0)
    calls = cfg.num_layers * (2 if cfg.cross_attention else 1) + cfg.encoder_layers
    return per * calls


# ---------------------------------------------------------------------------
# the port, one function a rank
# ---------------------------------------------------------------------------

def prefill(mesh, cfg, ins: dict, fsdp: bool) -> dict:
    """The prefill's (B_loc, V_loc) block gathered to the whole (B, V)
    logits, and the step's collective calls."""
    step = T.make_prefill_step(cfg, mesh, fsdp=fsdp, batch=B)
    lp = local_shard(mesh, params_from_numpy(ins["weights"], "cpu"), step.par.pspecs)
    batch = {k: torch.from_numpy(v) for k, v in ins["prefill"].items()}
    batch["tokens"] = batch["tokens"].long()
    bspecs = T.infer_batch_pspecs(batch, T.data_axes_of(mesh), mesh)
    rows = local_shard(mesh, batch, bspecs)
    with OpCosts() as oc:
        blk = step(lp, rows)
    full = gather_tree(mesh, {"l": blk}, {"l": (bspecs["tokens"][0], "model")})["l"]
    return {"logits": full.numpy(), "calls": oc.counts()["collective_calls"]}


def grads(mesh, cfg, ins: dict, remat: bool = True) -> dict:
    """The sharded loss and gradients in ``cross_device`` (gathered whole,
    an unused leaf's as zeros) and the step's collective calls, each block
    recomputed in the backward under ``remat``."""
    _, pspecs = T._mesh_pspecs(cfg, "cross_device")
    par = T.train_par(cfg, mesh, "cross_device", pspecs)
    lp = local_shard(mesh, params_from_numpy(ins["weights"], "cpu"), pspecs)
    batch = {k: torch.from_numpy(v) for k, v in ins["batch"].items()}
    batch["tokens"] = batch["tokens"].long()
    with OpCosts() as oc:
        loss, g = T.sharded_value_and_grad(par, lp, batch, remat=remat)
    g = {k: torch.zeros_like(lp[k]) if v is None else v for k, v in g.items()}
    return {"loss": float(loss), "calls": oc.counts()["collective_calls"],
            "grads": {k: v.numpy() for k, v in gather_tree(mesh, g, pspecs).items()}}


def rank_cases(mesh, cases: dict) -> dict:
    os.nice(10)
    torch.set_num_threads(1)
    out = {}
    for name, (arch, overrides, serve_ins, grad_ins) in cases.items():
        cfg = case_config(arch, overrides)
        out[name] = {"default": prefill(mesh, cfg, serve_ins, False),
                     "fsdp": prefill(mesh, cfg, serve_ins, True),
                     "grad": grads(mesh, cfg, grad_ins),
                     "grad_no_remat": grads(mesh, cfg, grad_ins, remat=False)}
    return out


def live_client_counts(mesh, arch: str, overrides: dict, tokens: np.ndarray) -> dict:
    """``client_deltas_sharded`` (one local step of one client) of a
    SMOKE config on the rank's shards, counted by ``OpCosts``, without and
    with remat: the live steps whose counts ``tests/test_torch_dryrun.py``
    holds its dry run to.  Returns rank 0's counts by ``remat``."""
    from repro_torch.core.safl import _f32
    from repro_torch.launch.dryrun import build_safl_cfg
    from repro_torch.models import init_params
    torch.set_num_threads(1)
    cfg = case_config(arch, overrides)
    safl = build_safl_cfg(cfg)
    _, pspecs = T._mesh_pspecs(cfg, "cross_device")
    lp = local_shard(mesh, init_params(cfg, torch.Generator().manual_seed(0), "cpu"),
                     pspecs)
    rows = {"tokens": torch.from_numpy(tokens).long()}
    out = {}
    for remat in (False, True):
        with OpCosts() as oc:
            T.client_deltas_sharded(cfg, safl, mesh, "cross_device", lp, rows,
                                    _f32(safl.client_lr), pspecs, remat=remat)
        out[remat] = oc.counts()
    return out


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def results():
    cases = {}
    for name, arch, over in CASES:
        cfg = case_config(arch, over)
        cases[name] = (arch, over, inputs(arch, cfg), model_inputs(arch, over))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ref = pool.submit(lambda: (
            serve_reference({n: (a, o, s) for n, (a, o, s, _) in cases.items()}),
            grad_reference({n: ("model", (a, o), g) for n, (a, o, _, g) in cases.items()})))
        port = spawn(rank_cases, *GRID, cases, device="cpu", timeout=600)
        return ref.result(), port


@pytest.mark.parametrize("case", NAMES)
def test_part_head_prefill_matches_reference(results, case):
    (serve, _), port = results
    want = serve[case]["prefill"]
    for layout in ("default", "fsdp"):
        got = port[case][layout]["logits"]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, err_msg=layout, **TOL)


@pytest.mark.parametrize("case", NAMES)
def test_part_head_grads_match_reference(results, case):
    (_, ref), port = results
    got, want = port[case]["grad"], ref[case]
    np.testing.assert_allclose(got["loss"], want["loss"], **TOL)
    assert got["grads"].keys() == want["grads"].keys()
    for k, w in want["grads"].items():
        np.testing.assert_allclose(got["grads"][k], w, err_msg=k, **TOL)


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_part_head_collectives_within_budget(results, remat):
    """One gather an attention call where only the kv heads split, two
    where the query heads split (q, k and v in one; the output back to
    ``wo``'s rows), each a reduce-scatter in the backward; on (data 1,
    model 4) nothing else gathers or reduce-scatters.  Under ``remat`` the
    backward recomputes each block, its gathers with it: the forward's
    gathers twice, the reduce-scatters once."""
    _, port = results
    n = GRID[0][1]
    for name, arch, over in CASES:
        want = expected_gathers(case_config(arch, over), n)
        assert want > 0, name
        for layout in ("default", "fsdp"):
            calls = port[name][layout]["calls"]
            assert (calls["all_gather"], calls["reduce_scatter"]) == (want, 0), (name, calls)
        calls = port[name]["grad" if remat else "grad_no_remat"]["calls"]
        gathers = 2 * want if remat else want
        assert (calls["all_gather"], calls["reduce_scatter"]) == (gathers, want), (name, calls)


def test_head_plan_covers_every_head_once():
    """Every query head computed by exactly one rank, at most ceil(H / n)
    a rank; each query head reads kv head i // (H / Hkv), through the
    plan's grouping or its one-a-head repeat; a rank whose columns are
    part heads gathers."""
    for H, Hk, hd, n in PLANS:
        cfg = heads_cfg(H, Hk, hd)
        seen = []
        for r in range(n):
            p = head_plan(cfg, H * hd // n, Hk * hd // n, n, r)
            heads = list(range(p.q0, p.q1))
            seen += heads
            assert len(heads) <= -(-H // n), (H, Hk, hd, n, r)
            group = max(len(heads) // p.num_kv, 1)
            assert [p.kv[j // group] for j in range(len(heads))] == \
                [i // (H // Hk) for i in heads], (H, Hk, hd, n, r, p)
            assert p.gather_q == bool(H * hd // n % hd)
            assert p.gather_kv == bool(Hk * hd // n % hd)
            if p.gather_q:
                assert p.starts == tuple(j * H // n for j in range(n + 1))
        assert sorted(seen) == list(range(H)), (H, Hk, hd, n)


def test_head_plan_changes_nothing_where_heads_divide():
    """Whole heads: the rank's own query and kv heads, their grouping, and
    no gather; the flat layout's whole columns: every head."""
    for H, Hk, hd, n in ((4, 2, 32, 2), (32, 8, 64, 8), (28, 4, 128, 4), (20, 20, 64, 4),
                         (128, 128, 192, 16)):
        cfg = heads_cfg(H, Hk, hd)
        for r in range(n):
            p = head_plan(cfg, H * hd // n, Hk * hd // n, n, r)
            hq, hk = H // n, Hk // n
            assert p.whole and not p.gather_q and not p.gather_kv
            assert (p.q0, p.q1, p.kv, p.num_kv) == (r * hq, (r + 1) * hq,
                                                   tuple(range(r * hk, (r + 1) * hk)), hk)
        p = head_plan(cfg, H * hd, Hk * hd, n, n - 1)
        assert p.whole and (p.q0, p.q1, p.kv, p.num_kv) == (0, H, tuple(range(Hk)), Hk)
