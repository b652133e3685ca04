"""Rematerialization: the reference's per-block ``jax.checkpoint`` in the
port's one-process and sharded client steps.

``models.model.remat_block`` runs each block under
``torch.utils.checkpoint`` (non-reentrant, no RNG state) when ``remat`` is
set and grad is on.  The recompute runs the same code on the same inputs,
so on the CPU the loss and every gradient are the same bits with and
without it: held for one arch of each family (dense, MoE, MLA with MTP,
Mamba, hybrid, encoder-decoder, vision), and the backward keeps fewer
bytes outside the blocks.  With it on, the port's gradients match the
reference's ``loss_fn(remat=True)`` from the same numpy weights, within
``tests/test_torch_zoo_dense.py``'s tolerances.

On four gloo CPU ranks, ``launch.train.client_deltas_sharded`` (two local
steps) in the default layout (``cross_device`` on (data 2, model 2)), FSDP
(``cross_silo`` on (pod 1, data 2, model 2)) and dbrx's MoE group: each
rank's delta the same bits with and without remat, and the collective
calls of each, exactly: the recompute runs a block's forward calls up to
its last saved activation again (PyTorch's early stop), so a block's
last sum is not repeated; the backward's calls are unchanged.

``launch.op_costs.OpCosts`` on ``meta`` tensors counts a checkpointed
step: the recompute's FLOPs (the blocks' forward less each block's last
projection, exactly), a lower peak (the freed activations), and, under a
fake process group, the collective calls and bytes of the live gloo step.

The Fig. 5 HVP (``core.intrinsic_dim.make_hvp``) runs under
``torch.func``, which refuses a checkpointed block: its callers pass
``remat=False``, and the values match the reference's, which recomputes.

No jax at the top: the ranks import this module by name.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.checkpoint.io import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.safl import SAFLConfig, _f32, client_delta
from repro_torch.launch import dryrun as D
from repro_torch.launch import train as T
from repro_torch.launch.mesh import make_mesh, spawn
from repro_torch.launch.op_costs import OpCosts
from repro_torch.models.model import forward, init_params, loss_fn, param_shapes
from repro_torch.models.sharding import local_shard

from torch_priority import lower_priority  # noqa: F401 (autouse)

# one arch of each family: dense, MoE, MLA + MTP, Mamba, hybrid,
# encoder-decoder, vision
FAMILIES = ("llama3_2_1b", "dbrx_132b", "deepseek_v3_671b", "falcon_mamba_7b",
            "jamba_1_5_large_398b", "whisper_large_v3", "qwen2_vl_7b")
REFERENCE_ARCHS = ("llama3_2_1b", "deepseek_v3_671b")
GRID = ((2, 2), ("data", "model"))
SILO = ((1, 2, 2), ("pod", "data", "model"))
# (case, arch, topology): the default layout, FSDP, the MoE group
MESH_CASES = (("llama3_2_1b/default", "llama3_2_1b", "cross_device"),
              ("llama3_2_1b/fsdp", "llama3_2_1b", "cross_silo"),
              ("dbrx_132b/default", "dbrx_132b", "cross_device"))
K, MB, S = 2, 4, 16                       # the mesh client's steps, rows, tokens
MESH_CFG = SAFLConfig(client_lr=0.5, local_steps=K)
# each mesh case's collective calls on rank 0 by kind, (without, with remat),
# for K = 2 steps of 2 layers.  A layer's forward sums its attention's and
# its MLP's outputs over ``model``; the recompute sums the attention's again
# (the MLP's sum is the layer's last op, which no backward reads): +K x 2
# all_reduce.  FSDP gathers each of a layer's 7 matrices over ``data`` where
# it reads them, and the recompute gathers them again: +K x 2 x 7
# all_gather; the backward's reduce-scatters stay one a gather of the
# forward.  dbrx's MoE layer ends in its experts' sum: +K x 2 all_reduce.
MESH_CALLS = {
    "llama3_2_1b/default": ({"all_reduce": 24}, {"all_reduce": 28}),
    "llama3_2_1b/fsdp": ({"all_reduce": 28, "all_gather": 32, "reduce_scatter": 32},
                         {"all_reduce": 32, "all_gather": 60, "reduce_scatter": 32}),
    "dbrx_132b/default": ({"all_reduce": 28}, {"all_reduce": 32}),
}
OP_B, OP_S = 4, 512                       # the meta step: activations dominate


def smoke(arch: str):
    return get_config(arch, smoke=True)


def smoke_batch(cfg, B: int = 2, S: int = 20, seed: int = 0) -> dict:
    """numpy tokens, and the frontend's embeddings where the family has one
    (``tests/test_torch_zoo_dense.py``'s layout)."""
    rng = np.random.RandomState(seed)
    batch = {"tokens": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = (rng.randn(B, cfg.num_frontend_tokens, cfg.d_model)
                                 * 0.02).astype(np.float32)
    if cfg.frontend == "audio":
        batch["audio_embeds"] = (rng.randn(B, cfg.encoder_seq, cfg.d_model)
                                 * 0.02).astype(np.float32)
    return batch


def port_step(cfg, params: dict, batch: dict, remat: bool):
    """(loss, gradients by path, bytes the backward keeps outside the
    checkpointed blocks) of one-process ``loss_fn``."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    kept = [0]

    def pack(t):
        kept[0] += t.numel() * t.element_size()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = loss_fn(cfg, leaves, tb, remat=remat)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), dict(zip(leaves, grads)), kept[0]


# ---------------------------------------------------------------------------
# the port, one function a rank
# ---------------------------------------------------------------------------

def mesh_case(mesh, arch: str, topology: str) -> dict:
    """``client_deltas_sharded`` of one client on the rank's shards and
    rows, without and with remat: whether every rank's deltas and losses
    are the same bits, and rank 0's collective calls and bytes of each."""
    cfg = smoke(arch)
    _, pspecs = T._mesh_pspecs(cfg, topology)
    lp = local_shard(mesh, init_params(cfg, torch.Generator().manual_seed(0), "cpu"),
                     pspecs)
    tokens = torch.randint(0, cfg.vocab_size, (1, K, MB, S),
                           generator=torch.Generator().manual_seed(1))
    out = {}
    for remat in (False, True):
        with OpCosts() as oc:
            deltas, losses = T.client_deltas_sharded(
                cfg, MESH_CFG, mesh, topology, lp, {"tokens": tokens},
                _f32(MESH_CFG.client_lr), pspecs, remat=remat)
        c = oc.counts()
        out[remat] = {"deltas": deltas, "losses": losses,
                      "calls": {k: n for k, n in c["collective_calls"].items() if n},
                      "bytes": c["collective_bytes"]}
    a, b = out[False], out[True]
    same = torch.equal(a["losses"], b["losses"]) and all(
        torch.equal(a["deltas"][k], b["deltas"][k]) for k in a["deltas"])
    flag = torch.tensor([1.0 if same else 0.0])
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return {"bitwise": bool(flag.item() == 1.0),
            "calls": {r: out[r]["calls"] for r in out},
            "bytes": {r: out[r]["bytes"] for r in out}}


def rank_cases(mesh) -> dict:
    os.nice(10)
    torch.set_num_threads(1)
    silo = make_mesh(*SILO, device="cpu")
    return {name: mesh_case(silo if top == "cross_silo" else mesh, arch, top)
            for name, arch, top in MESH_CASES}


@pytest.fixture(scope="module")
def mesh_results():
    return spawn(rank_cases, *GRID, device="cpu", timeout=600)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_one_process_remat_is_bitwise(arch):
    """The loss and every gradient with remat are the bits without it, and
    the backward keeps fewer bytes outside the blocks."""
    cfg = smoke(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = smoke_batch(cfg)
    l0, g0, kept0 = port_step(cfg, params, batch, remat=False)
    l1, g1, kept1 = port_step(cfg, params, batch, remat=True)
    assert torch.equal(l0, l1), (float(l0), float(l1))
    assert g0.keys() == g1.keys()
    for k, a in g0.items():
        b = g1[k]
        assert (a is None and b is None) or torch.equal(a, b), k
    assert kept1 < kept0, (kept1, kept0)


@pytest.mark.parametrize("arch", REFERENCE_ARCHS)
def test_remat_matches_reference(arch):
    """The port's ``loss_fn(remat=True)`` gradients against
    ``jax.value_and_grad`` of the reference's ``loss_fn(remat=True)``
    from the same weights (the reference's init carried across)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as r_config
    from repro.models import loss_fn as r_loss
    from test_torch_zoo_dense import GRAD_TOL, LOSS_TOL, flat, ref_init

    rcfg, cfg = r_config(arch, smoke=True), smoke(arch)
    batch = smoke_batch(cfg)
    rparams = ref_init(rcfg, 1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rl, rg = jax.jit(jax.value_and_grad(
        lambda p: r_loss(rcfg, p, jb, remat=True)))(rparams)
    tparams = params_from_numpy(flat(rparams), "cpu")
    assert list(tparams) == list(param_shapes(cfg))
    tl, tg, _ = port_step(cfg, tparams, batch, remat=True)
    np.testing.assert_allclose(float(tl), float(rl), **LOSS_TOL)
    for k, want in flat(rg).items():
        got = np.zeros_like(want) if tg[k] is None else tg[k].numpy()
        np.testing.assert_allclose(got, want, err_msg=k, **GRAD_TOL)


@pytest.mark.parametrize("case", [c[0] for c in MESH_CASES])
def test_mesh_delta_is_bitwise_with_remat(mesh_results, case):
    """Every rank's delta and loss the same bits with and without remat:
    the recompute's collectives sum the same inputs in gloo's fixed order."""
    assert mesh_results[case]["bitwise"]


def test_mesh_collective_calls_with_and_without_remat(mesh_results):
    """Each mesh case's collective calls by kind, exactly (``MESH_CALLS``);
    the recompute adds forward calls and never a backward one."""
    for name, _, _ in MESH_CASES:
        calls = mesh_results[name]["calls"]
        assert (calls[False], calls[True]) == MESH_CALLS[name], (name, calls)
        assert calls[True].get("reduce_scatter", 0) == calls[False].get("reduce_scatter", 0)


def meta_step(cfg, remat: bool) -> dict:
    """``OpCosts`` of one-process ``client_delta`` (one local step) on
    ``meta`` tensors: (OP_B, OP_S) tokens, nothing allocated."""
    params = {k: torch.empty(s, dtype=cfg.dtype, device="meta")
              for k, s in param_shapes(cfg).items()}
    mb = {"tokens": torch.empty((1, OP_B, OP_S), dtype=torch.int64, device="meta")}
    with OpCosts((params, mb)) as oc:
        out = client_delta(MESH_CFG, lambda p, b: loss_fn(cfg, p, b, remat=remat),
                           params, mb, 0.01)
        oc.set_outputs(out)
    return oc.counts()


def test_op_costs_peak_is_lower_with_remat():
    """The freed forward activations leave the count (the weak references'
    callbacks fire under the checkpoint's recompute too): the peak falls;
    the arguments and outputs are the same bytes."""
    cfg = smoke("llama3_2_1b")
    plain, remat = meta_step(cfg, False)["memory"], meta_step(cfg, True)["memory"]
    assert remat["argument_bytes"] == plain["argument_bytes"] > 0
    assert remat["output_bytes"] == plain["output_bytes"]
    assert remat["peak_bytes"] < 0.8 * plain["peak_bytes"], (remat, plain)


def test_op_costs_counts_the_recompute_flops():
    """FLOPs with remat = without + the blocks' forward, less each block's
    last projection (the MLP's ``wo``, which the recompute stops before),
    exactly: the counting mode is active inside ``autograd.grad``."""
    cfg = smoke("llama3_2_1b")
    plain, remat = meta_step(cfg, False)["flops"], meta_step(cfg, True)["flops"]
    from torch.utils.flop_counter import FlopCounterMode
    params = {k: torch.empty(s, dtype=cfg.dtype, device="meta")
              for k, s in param_shapes(cfg).items()}
    tokens = torch.empty((OP_B, OP_S), dtype=torch.int64, device="meta")
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        forward(cfg, params, {"tokens": tokens})
    last = 2 * OP_B * OP_S * cfg.d_ff * cfg.d_model * cfg.num_layers
    assert remat - plain == fc.get_total_flops() - last, (remat, plain)
    assert remat > plain


def test_op_costs_dry_step_counts_the_live_collectives(mesh_results):
    """The dry run (a fake group, ``meta`` shards) of the llama3.2-1b
    default case counts the live gloo step's collective calls and bytes,
    with and without remat."""
    cfg = smoke("llama3_2_1b")
    tokens = torch.empty((GRID[0][0], K, MB, S), dtype=torch.int64, device="meta")
    live = mesh_results["llama3_2_1b/default"]
    for remat in (False, True):
        dry = D.dry_run(cfg, *GRID, {"batch": {"tokens": tokens}}, kind="client",
                        safl=MESH_CFG, remat=remat)["counts"]
        calls = {k: n for k, n in dry["collective_calls"].items() if n}
        assert calls == live["calls"][remat], (remat, calls, live["calls"])
        assert dry["collective_bytes"] == live["bytes"][remat], remat


def test_hvp_keeps_activations_and_matches_the_reference():
    """``make_hvp`` of the port's ``loss_fn(remat=False)`` (its callers')
    against the reference's HVP of ``loss_fn(remat=True)`` at llama3.2-1b
    SMOKE on the same vector (``test_torch_intrinsic_dim.py``'s tolerance);
    a checkpointed loss is refused by ``torch.func``, not run another way."""
    import jax.numpy as jnp

    from repro.configs import get_config as r_config
    from repro.core.intrinsic_dim import make_hvp as r_make_hvp
    from repro.models import loss_fn as r_loss
    from repro_torch.core.intrinsic_dim import make_hvp
    from test_torch_zoo_dense import flat, ref_init

    rcfg, cfg = r_config("llama3_2_1b", smoke=True), smoke("llama3_2_1b")
    batch = smoke_batch(cfg, S=16)
    rparams = ref_init(rcfg, 1)
    tparams = params_from_numpy(flat(rparams), "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    rmv, d = r_make_hvp(lambda p, b: r_loss(rcfg, p, b, remat=True), rparams,
                        {k: jnp.asarray(v) for k, v in batch.items()})
    tmv, d2 = make_hvp(lambda p, b: loss_fn(cfg, p, b, remat=False), tparams, tb)
    assert d == d2
    v = np.random.RandomState(0).randn(d).astype(np.float32)
    want = np.asarray(rmv(jnp.asarray(v)))
    got = tmv(torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())
    bad, _ = make_hvp(lambda p, b: loss_fn(cfg, p, b, remat=True), tparams, tb)
    with pytest.raises(RuntimeError, match="saved tensor hooks"):
        bad(torch.from_numpy(v))
