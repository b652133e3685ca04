"""Sharded serving on four gloo CPU ranks against the reference.

``make_serve_step`` and ``make_prefill_step`` with a live (data 2, model 2)
mesh run ``models/parallel.py`` on each rank's own blocks: decode in the
default layout, under FSDP and in the flat layout, prefill in the default
layout and under FSDP (the reference serves the flat layout for decode
only).  Each SMOKE architecture in float32, from the reference's weights
(the port's init carried over as numpy, ``params_from_numpy`` on the
ranks), B = 4, max_seq 32: 16 teacher-forced decode steps, then 8 greedy
steps whose tokens feed back (h2o-danube's 16-slot ring wraps), against the
reference's jitted ``decode_step`` run the same way in the parent on the
CPU; the prefill's (B_loc, V_loc) blocks against the reference's
``make_prefill_step`` (B = 4, 16 tokens).  Logits and gathered caches
within rtol 1e-4 / atol 1e-5 (jamba's Mamba state and prefill atol 2e-5,
the class of tests/test_torch_zoo_ssm.py), greedy tokens exact.

On every rank, after the steps: its weight blocks are ``local_shard``'s
cut of the whole tree bit for bit and its cache blocks ``local_shard``'s
cut of the gathered cache, shapes exact; and no gather inside a step
(``all_gather``/``all_gather_into_tensor`` of the process groups)
returns more than the step's logits, apart from FSDP's per-leaf gather
over ``data`` (at most one depth slice of one leaf's model-sharded
block).

This module serves six architectures; ``test_torch_serve_mesh_layouts.py``
the other six and a MoE prefill whose capacity drops choices.  Each runs
ONE ``launch.mesh.spawn`` of four ranks for all its cases while the
reference runs in a thread of the parent.  This module imports no jax at
its top: the ranks import it by name.
"""

import concurrent.futures
import math
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.checkpoint.io import params_from_numpy, params_to_numpy
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import train as T
from repro_torch.launch.mesh import spawn
from repro_torch.models import init_cache, init_params, parallel
from repro_torch.models.model import cache_shapes
from repro_torch.models.sharding import _block, gather_tree, local_shard

from torch_priority import lower_priority  # noqa: F401 (autouse)

GRID = ((2, 2), ("data", "model"))
B, MAX_SEQ, TF, GREEDY, S_PREFILL = 4, 32, 16, 8, 16
DECODE = (("default", False), ("fsdp", True), ("flat", False))   # (name, fsdp)
TOL = dict(rtol=1e-4, atol=1e-5)
JAMBA_TOL = dict(rtol=1e-4, atol=2e-5)
HERE = ARCHS[:6]


def tol_for(arch: str) -> dict:
    return JAMBA_TOL if arch.startswith("jamba") else TOL


def inputs(arch: str, cfg=None) -> dict:
    """numpy inputs of one case: the weights (the port's init, seed 1), the
    teacher-forced tokens, an audio model's frames, the prefill batch."""
    cfg = cfg or get_config(arch, smoke=True)
    rs = np.random.RandomState(0)
    out = {"weights": params_to_numpy(init_params(cfg, torch.Generator().manual_seed(1),
                                                  "cpu")),
           "tokens": rs.randint(0, cfg.vocab_size, (B, TF)).astype(np.int32),
           "prefill": {"tokens": rs.randint(0, cfg.vocab_size,
                                            (B, S_PREFILL)).astype(np.int32)}}
    if cfg.encoder_layers:
        out["audio"] = (rs.randn(B, cfg.encoder_seq, cfg.d_model) * 0.02).astype(np.float32)
        out["prefill"]["audio_embeds"] = out["audio"]
    if cfg.frontend == "vision":
        out["prefill"]["patch_embeds"] = rs.randn(
            B, cfg.num_frontend_tokens, cfg.d_model).astype(np.float32)
    return out


# ---------------------------------------------------------------------------
# the reference, in the parent
# ---------------------------------------------------------------------------

def reference(cases: dict) -> dict:
    """Each case's decode (teacher-forced, then greedy) and prefill through
    the reference's jitted steps."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as r_config
    from repro.launch.train import make_prefill_step, make_serve_step
    from repro.models import init_cache as r_init_cache
    from repro.models.model import encode_for_decode

    out = {}
    for name, (arch, overrides, ins) in cases.items():
        rcfg = dataclasses.replace(r_config(arch, smoke=True), **overrides)
        rp = {}
        for path, a in ins["weights"].items():
            *heads, leaf = path.split("/")
            node = rp
            for h in heads:
                node = node.setdefault(h, {})
            node[leaf] = jnp.asarray(a)
        res = {"prefill": np.asarray(jax.jit(make_prefill_step(rcfg))(
            rp, {k: jnp.asarray(v) for k, v in ins["prefill"].items()}))}
        if name == arch:
            step = jax.jit(make_serve_step(rcfg))
            cache = r_init_cache(rcfg, B, MAX_SEQ)
            if rcfg.encoder_layers:
                cache = encode_for_decode(rcfg, rp, cache, jnp.asarray(ins["audio"]))
            tok, logits, greedy = jnp.asarray(ins["tokens"][:, :1]), [], []
            for t in range(TF + GREEDY):
                lo, cache = step(rp, cache, tok, jnp.asarray(t, jnp.int32))
                logits.append(np.asarray(lo))
                if t + 1 < TF:
                    tok = jnp.asarray(ins["tokens"][:, t + 1:t + 2])
                else:
                    tok = jnp.argmax(lo, axis=-1).astype(jnp.int32)[:, None]
                    greedy.append(np.asarray(tok[:, 0]))
            leaves, _ = jax.tree_util.tree_flatten_with_path(cache)
            res.update(logits=np.stack(logits), tokens=np.stack(greedy[:GREEDY], 1),
                       cache={"/".join(k.key for k in p): np.asarray(v) for p, v in leaves})
        out[name] = res
    return out


# ---------------------------------------------------------------------------
# the port, one function a rank
# ---------------------------------------------------------------------------

def all_ranks(ok: bool) -> bool:
    """True when ``ok`` holds on every rank."""
    flag = torch.tensor([1.0 if ok else 0.0])
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item() == 1.0)


class Gathers:
    """Records the size of every gather's output, and whether it is over
    ``data`` alone, while inside the ``with``: the process groups'
    ``all_gather``/``all_gather_into_tensor``."""

    NAMES = ("all_gather", "all_gather_into_tensor")

    def __init__(self, mesh):
        self.data_group = mesh.group(("data",))

    def __enter__(self):
        self.sizes, self.orig = [], {n: getattr(dist, n) for n in self.NAMES}

        def gather(tensor_list, tensor, group=None, async_op=False):
            self.sizes.append((sum(t.numel() for t in tensor_list),
                               group is self.data_group))
            return self.orig["all_gather"](tensor_list, tensor, group=group,
                                           async_op=async_op)

        def gather_into(output, tensor, group=None, async_op=False):
            self.sizes.append((output.numel(), group is self.data_group))
            return self.orig["all_gather_into_tensor"](output, tensor, group=group,
                                                       async_op=async_op)

        dist.all_gather, dist.all_gather_into_tensor = gather, gather_into
        return self

    def __exit__(self, *exc):
        for n, f in self.orig.items():
            setattr(dist, n, f)


def leaf_block_limit(mesh, cfg) -> int:
    """The largest model-sharded block of one depth slice of one weight:
    what FSDP's gather over ``data`` may return."""
    meta = T._meta_params(cfg)
    specs = T.param_pspecs(meta, fsdp=False)
    most = 0
    for k, x in meta.items():
        n = math.prod(s.stop - s.start for s in _block(mesh, x.shape, specs[k]))
        most = max(most, n // x.shape[0] if k.split("/")[0].endswith("layers") else n)
    return most


def blocks_are_local_shards(mesh, full: dict, local: dict, specs: dict) -> bool:
    """Every block is ``local_shard``'s cut of the whole tree, bit for bit,
    with ``_block``'s shape."""
    cut = local_shard(mesh, full, specs)
    for k, x in local.items():
        shape = tuple(s.stop - s.start for s in _block(mesh, full[k].shape, specs[k]))
        if tuple(x.shape) != shape or not torch.equal(x, cut[k]):
            return False
    return True


def serve_decode(mesh, cfg, ins: dict, layout: str, fsdp: bool) -> dict:
    """One case's decode on this rank: teacher-forced, then greedy."""
    step = T.make_serve_step(cfg, mesh, layout=layout, fsdp=fsdp, batch=B,
                             max_seq=MAX_SEQ)
    par = step.par
    tspec = T.serve_specs(cfg, mesh, B, MAX_SEQ, layout=layout, fsdp=fsdp)[2]
    params = params_from_numpy(ins["weights"], "cpu")
    lp = local_shard(mesh, params, par.pspecs)
    lc = local_shard(mesh, init_cache(cfg, B, MAX_SEQ, "cpu"), par.cspecs)
    rows = local_shard(mesh, {"t": torch.from_numpy(ins["tokens"]).long()},
                       {"t": tspec})["t"]
    if cfg.encoder_layers:
        audio = local_shard(mesh, {"a": torch.from_numpy(ins["audio"])},
                            {"a": (tspec[0], None, None)})["a"]
        parallel.encode_for_decode(par, lp, lc, audio)
    tok, logits, greedy = rows[:, :1], [], []
    with Gathers(mesh) as g:
        for t in range(TF + GREEDY):
            lo, lc = step(lp, lc, tok, torch.tensor(t))
            logits.append(lo)
            if t + 1 < TF:
                tok = rows[:, t + 1:t + 2]
            else:
                tok = torch.argmax(lo, dim=-1)[:, None]
                greedy.append(tok[:, 0])
    full_cache = gather_tree(mesh, lc, par.cspecs)
    both = gather_tree(mesh, {"l": torch.stack(logits), "t": torch.stack(greedy[:GREEDY], 1)},
                       {"l": (None, tspec[0], None), "t": (tspec[0], None)})
    limit = rows.shape[0] * cfg.padded_vocab
    leaf = leaf_block_limit(mesh, cfg)
    gathers_ok = all(n <= limit or (fsdp and over_data and n <= leaf)
                     for n, over_data in g.sizes)
    blocks_ok = (blocks_are_local_shards(mesh, params, lp, par.pspecs)
                 and blocks_are_local_shards(mesh, full_cache, lc, par.cspecs)
                 and set(lc) == set(cache_shapes(cfg, B, MAX_SEQ)))
    return {"logits": both["l"].numpy(), "tokens": both["t"].numpy(),
            "cache": {k: v.numpy() for k, v in full_cache.items()},
            "blocks_ok": all_ranks(blocks_ok), "gathers_ok": all_ranks(gathers_ok),
            "largest_gather": max((n for n, _ in g.sizes), default=0)}


def serve_prefill(mesh, cfg, ins: dict, fsdp: bool) -> np.ndarray:
    """One case's prefill on this rank: its (B_loc, V_loc) block, gathered
    to the whole (B, V) logits (each block checked against ``local_shard``'s
    cut of them)."""
    step = T.make_prefill_step(cfg, mesh, fsdp=fsdp, batch=B)
    params = params_from_numpy(ins["weights"], "cpu")
    lp = local_shard(mesh, params, step.par.pspecs)
    batch = {k: torch.from_numpy(v) for k, v in ins["prefill"].items()}
    batch["tokens"] = batch["tokens"].long()
    bspecs = T.infer_batch_pspecs(batch, T.data_axes_of(mesh), mesh)
    with Gathers(mesh) as g:
        blk = step(lp, local_shard(mesh, batch, bspecs))
    spec = (bspecs["tokens"][0], "model")
    full = gather_tree(mesh, {"l": blk}, {"l": spec})["l"]
    ok = (blocks_are_local_shards(mesh, {"l": full}, {"l": blk}, {"l": spec})
          and blocks_are_local_shards(mesh, params, lp, step.par.pspecs)
          and all(n <= blk.numel() or (fsdp and over_data
                                       and n <= leaf_block_limit(mesh, cfg))
                  for n, over_data in g.sizes))
    if not all_ranks(ok):
        raise AssertionError(f"{cfg.name} prefill (fsdp={fsdp}): a block or a gather "
                             "is not what the layout gives")
    return full.numpy()


def serve_cases(mesh, cases: dict) -> dict:
    """Every case on this rank: the decode layouts for each architecture
    (a case named after it), prefill in the default layout and under FSDP
    for every case."""
    import dataclasses
    os.nice(10)
    torch.set_num_threads(1)
    out = {}
    for name, (arch, overrides, ins) in cases.items():
        cfg = dataclasses.replace(get_config(arch, smoke=True), **overrides)
        res = {f"prefill/{'fsdp' if f else 'default'}": serve_prefill(mesh, cfg, ins, f)
               for f in (False, True)}
        if name == arch:
            for layout, fsdp in DECODE:
                res[layout] = serve_decode(mesh, cfg, ins,
                                           "flat" if layout == "flat" else "default", fsdp)
        out[name] = res
    return out


def run_cases(cases: dict) -> tuple[dict, dict]:
    """(reference, port): the reference in a thread of this process while
    the port's four ranks run."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ref = pool.submit(reference, cases)
        port = spawn(serve_cases, *GRID, cases, device="cpu", timeout=600)
        return ref.result(), port


def decode_runs(port: dict) -> list[str]:
    """The decode runs of one case's results."""
    return [k for k in port if not k.startswith("prefill/")]


def check_decode(ref: dict, port: dict, arch: str) -> None:
    tol = tol_for(arch)
    assert len(decode_runs(port)) == len(DECODE)
    for layout in decode_runs(port):
        got = port[layout]
        np.testing.assert_allclose(got["logits"], ref["logits"], err_msg=layout, **tol)
        np.testing.assert_array_equal(got["tokens"], ref["tokens"], err_msg=layout)
        assert list(got["cache"]) == list(ref["cache"])
        for k, w in ref["cache"].items():
            np.testing.assert_allclose(got["cache"][k], w, err_msg=f"{layout} {k}", **tol)


def check_prefill(ref: dict, port: dict, arch: str) -> None:
    for layout in ("default", "fsdp"):
        got = port[f"prefill/{layout}"]
        assert got.shape == ref["prefill"].shape
        np.testing.assert_allclose(got, ref["prefill"], err_msg=layout, **tol_for(arch))


@pytest.fixture(scope="module")
def results():
    return run_cases({arch: (arch, {}, inputs(arch)) for arch in HERE})


@pytest.mark.parametrize("arch", HERE)
def test_sharded_decode_matches_reference(results, arch):
    ref, port = results
    check_decode(ref[arch], port[arch], arch)


@pytest.mark.parametrize("arch", HERE)
def test_sharded_prefill_matches_reference(results, arch):
    ref, port = results
    check_prefill(ref[arch], port[arch], arch)


def test_rank_blocks_are_local_shards(results):
    for arch, res in results[1].items():
        for layout in decode_runs(res):
            assert res[layout]["blocks_ok"], (arch, layout)


def test_no_gather_exceeds_the_logits(results):
    for arch, res in results[1].items():
        for layout in decode_runs(res):
            assert res[layout]["gathers_ok"], (arch, layout, res[layout]["largest_gather"])
