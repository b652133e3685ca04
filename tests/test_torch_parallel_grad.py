"""The mesh client step's gradients on four gloo CPU ranks against the
reference.

``models/parallel.py``'s autograd collectives, each against its transpose
on two-rank groups: the sum (identity backward), the copy (identity
forward, sum backward), the gather of a replicated tensor (the backward
takes the rank's block) and FSDP's gather (the backward is a
reduce-scatter).  The vocab-parallel cross-entropy (``parallel._ce_sum``,
the vocabulary over ``model``) against the reference's
``_ce_loss_chunked``: a padded vocabulary, a sequence over two
``LOSS_CHUNK`` chunks with the tied head, and the MTP head's mask.  The
sharded loss and gradients (``launch.train.sharded_value_and_grad`` under
``train_par``) of bert_100m and llama3.2-1b SMOKE against the reference's
one-process ``jax.value_and_grad(loss_fn)`` from the same numpy weights, in
``cross_device`` on (data 2, model 2), ``cross_device_dp`` on (data 2,
model 2) and ``cross_silo`` on (pod 1, data 2, model 2): tensor
parallelism, FSDP and the batch's rows over ``data`` at once, a mesh the
reference's one-process side never partitions.  float32, rtol 1e-4 /
atol 1e-5 (``test_torch_serve_mesh.py``'s); jamba atol 2e-5.  And a pin
that ``client_deltas_sharded`` allocates no whole leaf: ``gather_tree``
raises inside the ranks, every tensor a step reads is a view of the rank's
shard with the shard's shape, and no gather returns more than one depth
slice of one leaf's model-sharded block (FSDP's, over ``data``).

``test_torch_parallel_grad_families.py`` runs the other families.  Each
module runs ONE ``launch.mesh.spawn`` of four ranks for all its cases while
the reference runs in a thread of the parent.  No jax at the top: the
ranks import this module by name.
"""

import concurrent.futures
import dataclasses
import os
from typing import Optional

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.checkpoint.io import params_from_numpy, params_to_numpy
from repro_torch.configs import get_config
from repro_torch.core.adaptive import AdaConfig
from repro_torch.core.safl import SAFLConfig
from repro_torch.core.sketch import SketchConfig
from repro_torch.launch import train as T
from repro_torch.launch.mesh import make_mesh, spawn
from repro_torch.models import init_params, parallel, sharding
from repro_torch.models.sharding import _block, gather_tree, local_shard
from test_torch_serve_mesh import Gathers, all_ranks, leaf_block_limit

from torch_priority import lower_priority  # noqa: F401 (autouse)

GRID = ((2, 2), ("data", "model"))
SILO = ((1, 2, 2), ("pod", "data", "model"))
TOPOLOGIES = ("cross_device", "cross_device_dp", "cross_silo")
B, S = 4, 16
TOL = dict(rtol=1e-4, atol=1e-5)
JAMBA_TOL = dict(rtol=1e-4, atol=2e-5)
HERE = ("bert_100m", "llama3_2_1b")
COLLECTIVES = ("sum", "copy", "gather", "gather_shards")
# (name, vocab_size, tie_embeddings, sequence, head): the cross-entropy cases
CE_CASES = (("padded_vocab", 200, False, 16, "lm_head"),
            ("two_chunks_tied", 256, True, 1100, "embed"),
            ("mtp_head", 256, False, 24, "mtp_head"))


def tol_for(arch: str) -> dict:
    return JAMBA_TOL if arch.startswith("jamba") else TOL


def model_inputs(arch: str, overrides: Optional[dict] = None, seed: int = 0) -> dict:
    """numpy inputs of a model case: the weights (the port's init, seed 1)
    and one microbatch of B rows (and an audio or vision model's frames)."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), **(overrides or {}))
    rs = np.random.RandomState(seed)
    batch = {"tokens": rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.encoder_layers:
        batch["audio_embeds"] = (rs.randn(B, cfg.encoder_seq, cfg.d_model)
                                 * 0.02).astype(np.float32)
    if cfg.frontend == "vision":
        batch["patch_embeds"] = rs.randn(B, cfg.num_frontend_tokens,
                                         cfg.d_model).astype(np.float32)
    return {"weights": params_to_numpy(init_params(cfg, torch.Generator().manual_seed(1),
                                                   "cpu")),
            "batch": batch}


def ce_inputs(vocab: int, tied: bool, seq: int, head: str) -> dict:
    rs = np.random.RandomState(vocab + seq)
    cfg = ce_config(vocab, tied)
    D, V = cfg.d_model, cfg.padded_vocab
    w = (rs.randn(V, D) if tied else rs.randn(D, V)).astype(np.float32) * 0.3
    labels = rs.randint(0, vocab, (2, seq)).astype(np.int32)
    mask = np.ones((2, seq), bool)
    mask[:, -(2 if head == "mtp_head" else 1):] = False
    return {"h": rs.randn(2, seq, D).astype(np.float32), "w": w,
            "labels": labels, "mask": mask}


def ce_config(vocab: int, tied: bool):
    return dataclasses.replace(get_config("llama3_2_1b", smoke=True), d_model=16,
                               vocab_size=vocab, tie_embeddings=tied)


# ---------------------------------------------------------------------------
# the reference, in the parent
# ---------------------------------------------------------------------------

def nested(flat: dict):
    import jax.numpy as jnp
    out = {}
    for path, a in flat.items():
        *heads, leaf = path.split("/")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = jnp.asarray(a)
    return out


def flat_paths(tree) -> dict:
    import jax
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(k.key for k in p): np.asarray(v) for p, v in leaves}


def reference(cases: dict) -> dict:
    """Each model case's loss and gradients through the reference's jitted
    ``value_and_grad(loss_fn)``; each cross-entropy case's through its
    ``_ce_loss_chunked``."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as r_config
    from repro.models.model import _ce_loss_chunked, loss_fn

    out = {}
    for name, (kind, spec, ins) in cases.items():
        if kind == "ce":
            vocab, tied, _, head = spec
            rcfg = dataclasses.replace(r_config("llama3_2_1b", smoke=True), d_model=16,
                                       vocab_size=vocab, tie_embeddings=tied)
            key = "embed" if tied else head

            def ce(h, w):
                return _ce_loss_chunked(rcfg, {key: w}, h, jnp.asarray(ins["labels"]),
                                        jnp.asarray(ins["mask"]), head_name=head)
            loss, (gh, gw) = jax.jit(jax.value_and_grad(ce, argnums=(0, 1)))(
                jnp.asarray(ins["h"]), jnp.asarray(ins["w"]))
            out[name] = {"loss": float(loss), "h": np.asarray(gh), "w": np.asarray(gw)}
            continue
        arch, overrides = spec
        rcfg = dataclasses.replace(r_config(arch, smoke=True), **overrides)
        batch = {k: jnp.asarray(v) for k, v in ins["batch"].items()}
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: loss_fn(rcfg, p, batch)))(nested(ins["weights"]))
        out[name] = {"loss": float(loss), "grads": flat_paths(grads)}
    return out


# ---------------------------------------------------------------------------
# the port, one function a rank
# ---------------------------------------------------------------------------

def collective_checks(mesh) -> dict:
    """Each autograd collective over the rank's two-rank ``model`` group,
    its backward against its transpose: with x_r the rank's input and g_r
    its output's cotangent, the sum and the replicated gather take a g
    that is the same on both ranks, the copy and FSDP's gather one that
    differs."""
    group = mesh.group(("model",))
    r = mesh.index_over(("model",))
    base = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    g_same = torch.linspace(-1.0, 1.0, 12).reshape(3, 4)
    g_mine = g_same * (r + 2)
    g_sum = g_same * 2 + g_same * 3                       # g_mine summed over both
    out = {}

    def grad_of(fn, x, g):
        x = x.clone().requires_grad_(True)
        y = fn(x)
        y.backward(g)
        return y.detach(), x.grad

    x = base + 10 * r
    y, gx = grad_of(lambda t: parallel._Sum.apply(t, group), x, g_same)
    out["sum"] = torch.equal(y, base * 2 + 10) and torch.equal(gx, g_same)
    y, gx = grad_of(lambda t: parallel._Copy.apply(t, group), base, g_mine)
    out["copy"] = torch.equal(y, base) and torch.allclose(gx, g_sum)
    whole = torch.cat([base, base + 10], dim=1)           # the blocks over columns
    g2 = torch.cat([g_same, -g_same], dim=1)
    y, gx = grad_of(lambda t: parallel._Gather.apply(t, group, 1), x, g2)
    out["gather"] = torch.equal(y, whole) and torch.equal(gx, g2[:, 4 * r:4 * r + 4])
    g2_mine = g2 * (r + 2)
    y, gx = grad_of(lambda t: parallel._GatherShards.apply(t, group, 1), x, g2_mine)
    out["gather_shards"] = (torch.equal(y, whole)
                            and torch.allclose(gx, (g2 * 5)[:, 4 * r:4 * r + 4]))
    return {k: all_ranks(v) for k, v in out.items()}


def ce_case(mesh, spec, ins: dict) -> dict:
    """The vocab-parallel cross-entropy of one case on the rank's
    vocabulary columns: (loss, dL/dh, dL/dW gathered whole)."""
    vocab, tied, _, head = spec
    cfg = ce_config(vocab, tied)
    par = parallel.Par(mesh, cfg, {}, {})
    w_spec = ("model", None) if tied else (None, "model")
    w = local_shard(mesh, {"w": torch.from_numpy(ins["w"])}, {"w": w_spec})["w"]
    h = torch.from_numpy(ins["h"]).requires_grad_(True)
    w = w.requires_grad_(True)
    mask = torch.from_numpy(ins["mask"])
    tot = parallel._ce_sum(par, parallel._copy(par, h), w.T if tied else w,
                           torch.from_numpy(ins["labels"]).long(), mask)
    loss = tot / mask.sum().to(torch.float32)
    gh, gw = torch.autograd.grad(loss, [h, w])
    full = gather_tree(mesh, {"w": gw}, {"w": w_spec})["w"]
    return {"loss": float(loss.detach()), "h": gh.numpy(), "w": full.numpy()}


def model_case(mesh, topology: str, cfg, ins: dict) -> dict:
    """One model case on one topology: the client's loss and the rank's
    gradients, gathered whole (an unused leaf's as zeros)."""
    _, pspecs = T._mesh_pspecs(cfg, topology)
    par = T.train_par(cfg, mesh, topology, pspecs)
    lp = local_shard(mesh, params_from_numpy(ins["weights"], "cpu"), pspecs)
    batch = {k: torch.from_numpy(v) for k, v in ins["batch"].items()}
    batch["tokens"] = batch["tokens"].long()
    loss, grads = T.sharded_value_and_grad(par, lp, T.shard_rows(par, batch, 0))
    grads = {k: torch.zeros_like(lp[k]) if g is None else g for k, g in grads.items()}
    full = gather_tree(mesh, grads, pspecs)
    same = torch.tensor([float(loss)])
    dist.all_reduce(same, op=dist.ReduceOp.MAX)
    return {"loss": float(loss), "loss_everywhere": float(same) == float(loss),
            "grads": {k: v.numpy() for k, v in full.items()}}


# the MoE slot offsets' gather: each batch shard's (chunks, E) counts
SMALL_GATHER = 1024
PIN_CFG = SAFLConfig(sketch=SketchConfig(kind="none"),
                     server=AdaConfig(name="amsgrad", lr=0.01), client_lr=0.5,
                     local_steps=2)


def whole_leaf_pin(mesh, topology: str, cfg, ins: dict) -> dict:
    """``client_deltas_sharded`` (K = 2) with ``gather_tree`` raising, every
    tensor ``Blocks`` reads checked against the shard it views, and every
    gather's size recorded."""
    _, pspecs = T._mesh_pspecs(cfg, topology)
    full = params_from_numpy(ins["weights"], "cpu")
    lp = local_shard(mesh, full, pspecs)
    shard = {k: tuple(s.stop - s.start for s in _block(mesh, v.shape, pspecs[k]))
             for k, v in full.items()}
    tokens = torch.from_numpy(ins["batch"]["tokens"]).long()
    batch = {"tokens": tokens.reshape(1, 2, B // 2, S).repeat(1, 1, 2, 1)}
    views, bad = {}, []
    orig_vg, orig_get, orig_gt = (T.sharded_value_and_grad,
                                  parallel.Blocks.__getitem__, sharding.gather_tree)

    def value_and_grad(par, params, b, **kw):
        views.clear()
        views.update({p.untyped_storage().data_ptr(): k for k, p in params.items()})
        return orig_vg(par, params, b, **kw)

    def getitem(self, path):
        x = self.tensors[path]
        k = views.get(x.untyped_storage().data_ptr())
        if k is None or tuple(x.shape) not in (shard[k], shard[k][1:]):
            bad.append((path, tuple(x.shape), k))
        return orig_get(self, path)

    def no_gather(*args, **kwargs):
        raise AssertionError("the client step gathered a tree")

    T.sharded_value_and_grad, parallel.Blocks.__getitem__ = value_and_grad, getitem
    sharding.gather_tree = no_gather
    try:
        with Gathers(mesh) as g:
            deltas, losses = T.client_deltas_sharded(cfg, PIN_CFG, mesh, topology, lp,
                                                     batch, 0.5, pspecs)
    finally:
        T.sharded_value_and_grad, parallel.Blocks.__getitem__ = orig_vg, orig_get
        sharding.gather_tree = orig_gt
    limit = leaf_block_limit(mesh, cfg)
    shapes_ok = all(tuple(deltas[k].shape[1:]) == shard[k] for k in full)
    return {"reads_ok": all_ranks(not bad and bool(views)), "bad": bad[:5],
            "gathers_ok": all_ranks(all((over_data and n <= limit) or n <= SMALL_GATHER
                                        for n, over_data in g.sizes)),
            "largest_gather": max((n for n, _ in g.sizes), default=0),
            "deltas_ok": all_ranks(shapes_ok), "finite": bool(torch.isfinite(losses).all())}


def codec_copies(mesh) -> bool:
    """One int8-codec round of ``test_torch_mesh_round.py``'s one-layer
    model in ``cross_silo`` on (pod 1, data 2, model 2): afterwards every
    copy of a leaf replicated over ``data`` or ``model`` (its params and
    moments) is bit for bit the same on every rank that holds one."""
    from repro_torch import fed, prng
    from repro_torch.core.safl import init_safl
    from repro_torch.data.synthetic import BigramLMData, LMDataConfig
    from repro_torch.models.config import ModelConfig
    from test_torch_mesh_round import MODEL_KW
    silo = make_mesh(*SILO, device="cpu")
    model = ModelConfig(**MODEL_KW)
    cfg = SAFLConfig(sketch=SketchConfig(kind="countsketch", ratio=0.05, min_b=16),
                     server=AdaConfig(name="amsgrad", lr=0.01), client_lr=0.5,
                     local_steps=2)
    _, pspecs = T._mesh_pspecs(model, "cross_silo")
    params = local_shard(silo, init_params(model, torch.Generator().manual_seed(0), "cpu"),
                         pspecs)
    smp = T.mesh_sampler(silo, BigramLMData(LMDataConfig(
        vocab_size=64, seq_len=16, num_clients=2, alpha=0.05)).device_sampler(8, 2),
        "cross_silo")
    params, state, _ = T.run_mesh_scan(
        model, cfg, silo, smp, params, init_safl(cfg, params), rounds=1,
        key=prng.key(3), topology="cross_silo",
        codec=fed.CodecConfig(bits=8, error_feedback=False))
    same = True
    for tree in (params, state["m"], state["v"], state["vhat"]):
        for k, x in tree.items():
            axes = [a for a in ("data", "model")
                    if a not in {b for e in pspecs[k] for b in sharding._entry_axes(e)}]
            group = silo.group(axes)
            if group is None:
                continue
            parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, x, group=group)
            same = same and all(torch.equal(p, parts[0]) for p in parts)
    return all_ranks(same)


def meshes_of(mesh) -> dict:
    silo = make_mesh(*SILO, device="cpu")
    return {"cross_device": mesh, "cross_device_dp": mesh, "cross_silo": silo}


def rank_cases(mesh, cases: dict, pins: tuple = ()) -> dict:
    """Every case on this rank: the collectives, each cross-entropy case,
    each model case on each topology, then the whole-leaf pins."""
    os.nice(10)
    torch.set_num_threads(1)
    meshes = meshes_of(mesh)
    out = {"collectives": collective_checks(mesh), "codec_copies": codec_copies(mesh)}
    for name, (kind, spec, ins) in cases.items():
        if kind == "ce":
            out[name] = ce_case(mesh, spec, ins)
            continue
        arch, overrides = spec
        cfg = dataclasses.replace(get_config(arch, smoke=True), **overrides)
        out[name] = {top: model_case(meshes[top], top, cfg, ins) for top in TOPOLOGIES}
    for name, top in pins:
        arch, overrides = cases[name][1]
        cfg = dataclasses.replace(get_config(arch, smoke=True), **overrides)
        out[f"pin/{name}/{top}"] = whole_leaf_pin(meshes[top], top, cfg, cases[name][2])
    return out


def run_cases(cases: dict, pins: tuple = ()) -> tuple[dict, dict]:
    """(reference, port): the reference in a thread of this process while
    the port's four ranks run."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ref = pool.submit(reference, cases)
        port = spawn(rank_cases, *GRID, cases, pins, device="cpu", timeout=900)
        return ref.result(), port


def check_model(ref: dict, got: dict, arch: str) -> None:
    tol = tol_for(arch)
    assert got["loss_everywhere"]
    np.testing.assert_allclose(got["loss"], ref["loss"], **tol)
    assert got["grads"].keys() == ref["grads"].keys()
    for k, want in ref["grads"].items():
        np.testing.assert_allclose(got["grads"][k], want, err_msg=k, **tol)


PINS = (("dbrx_132b/pin", "cross_device"), ("dbrx_132b/pin", "cross_silo"))


@pytest.fixture(scope="module")
def results():
    cases = {arch: ("model", (arch, {}), model_inputs(arch)) for arch in HERE}
    cases.update({name: ("ce", spec, ce_inputs(*spec)) for name, *spec in CE_CASES})
    cases["dbrx_132b/pin"] = ("model", ("dbrx_132b", {}), model_inputs("dbrx_132b"))
    return run_cases(cases, PINS)


@pytest.mark.parametrize("op", COLLECTIVES)
def test_collective_backward_is_its_transpose(results, op):
    assert results[1]["collectives"][op]


def test_replicated_copies_agree_after_a_codec_round(results):
    """The codec scales each shard's partial sum by its own range, so the
    desketched update of a replicated leaf differs between the shards that
    hold other slices; the round gives every copy the first member's."""
    assert results[1]["codec_copies"]


@pytest.mark.parametrize("case", [c[0] for c in CE_CASES])
def test_vocab_parallel_ce_matches_reference(results, case):
    ref, port = results
    np.testing.assert_allclose(port[case]["loss"], ref[case]["loss"], **TOL)
    np.testing.assert_allclose(port[case]["h"], ref[case]["h"], **TOL)
    np.testing.assert_allclose(port[case]["w"], ref[case]["w"], **TOL)


@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("arch", HERE)
def test_sharded_loss_and_grads_match_reference(results, arch, topology):
    ref, port = results
    check_model(ref[arch], port[arch][topology], arch)


@pytest.mark.parametrize("topology", [top for _, top in PINS])
def test_client_step_allocates_no_whole_leaf(results, topology):
    got = results[1][f"pin/dbrx_132b/pin/{topology}"]
    assert got["reads_ok"], got["bad"]
    assert got["gathers_ok"], got["largest_gather"]
    assert got["deltas_ok"] and got["finite"]
