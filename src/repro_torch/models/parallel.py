"""The model on each rank's own blocks of the weights and the cache, with
explicit collectives: sharded serving (the decode step, the prefill, the
encoder) and the mesh client step's loss and gradients.

Stands in for the GSPMD partitioning of ``repro/models/{layers,model}.py``
under ``param_pspecs``, ``cache_pspecs`` and the flat layout
(``flat_tp_pspecs``, ``flat_tp_cache_pspecs``): the reference jits its
one-process layers with those shardings and XLA inserts the collectives;
the port has no partitioner, so each function here takes the rank's
``Par`` (its mesh and layout) and its blocks, computes what the
one-process function of ``models.layers``/``models.model`` computes, and
runs the collectives itself, one over the process group of the axes it
reduces over (``Mesh.group``).  No function gathers a whole weight or a
whole cache leaf.

The layouts (``launch.train.make_serve_step``/``make_prefill_step``, and
``launch.train.train_par`` for the client step):

* default: each weight's model dim over ``model`` (heads, d_ff, d_inner,
  experts, the vocabulary), the batch over the data axes where it divides,
  the cache's sequence (Mamba's d_inner) over ``model``.  With ``fsdp`` the
  weights are cut over ``data`` too, and each block of a leaf is
  all-gathered over ``data`` just before it is used and dropped after
  (ZeRO's gather): that gives back the default layout's block.
* replicated (``cross_device_dp``'s client step): every weight whole, the
  batch's rows over ``model``; no tensor parallelism.
* flat (serving only, as in the reference): every weight's contracting dim
  over (data, model), the MoE experts over E, the embedding over V; the
  cache's sequence over (data, model); the batch replicated.  Each
  projection slices the rank's part of the replicated activation,
  multiplies it by the rank's rows and sums over the group: every output
  is whole.

The collectives: a row-parallel projection ends in one ``all_reduce``; a
column-parallel one is local.  Under autograd they are Megatron's pairs
(``_Sum``: sum, identity backward; ``_Copy``: identity, sum backward,
wherever a tensor that is the same on every rank of the group enters
rank-specific work; ``_Gather``: the backward takes the rank's block;
FSDP's gather: the backward reduce-scatters over ``data``), so a rank's
gradient of a replicated tensor is the whole one and of its blocks its
own.  Where a model axis splits heads (a rank's q or k/v columns are part
of a head), full-sequence attention gathers whole heads (``head_plan``):
each rank reads other heads of the gathered tensor, so that gather's
backward is a reduce-scatter, as FSDP's is.  The loss (``loss_fn``) is a
vocab-parallel cross-entropy on the
rank's (B, S_chunk, V_loc) logits, its row maximum, exponential sum and
gold logit summed over the group.  Decode attention runs over the cache's
own shards: the new token's q (and k, v) are gathered over the heads (B x
heads x hd, small), the rank that owns the slot writes it (a masked write
on the device, no host sync), and the softmax is the one GSPMD computes
over a sharded sequence: ``all_reduce`` MAX of the row maximum, SUM of the
exponentials, then the local ``probs @ v`` and a SUM, so each probability
is the unsharded softmax's number, cast the same way.  MoE experts run on
the rank that holds them, one ``all_reduce`` after; each choice's slot is
the one the global batch gives it (an exclusive prefix over the data
shards' counts, one small ``all_gather``).  The vocab-parallel head
gathers the ``(B, V)`` logits, so the greedy argmax is the one-process
``torch.argmax`` (ties to the lowest index).
"""

from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Any, Mapping, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import DENSE, LOSS_CHUNK, _positions_for, remat_block
from repro_torch.models.sharding import FSDP, _entry_axes


@dataclasses.dataclass(frozen=True, eq=False)
class Par:
    """One rank's view of a layout: its live mesh, the specs of every
    weight and cache leaf (flat dicts, as ``param_pspecs`` returns them),
    the axes the batch is cut over, whether the layout is the flat one,
    whether weights are also cut over ``data`` (FSDP), and whether they
    are whole on every rank (``replicated``: ``cross_device_dp``'s client
    step, no tensor parallelism)."""
    mesh: Any
    cfg: ModelConfig
    pspecs: Mapping[str, tuple]
    cspecs: Mapping[str, tuple]
    batch_axes: tuple[str, ...] = ()
    flat: bool = False
    fsdp: bool = False
    replicated: bool = False

    @property
    def tp(self) -> tuple[str, ...]:
        """The axes the weights' model-parallel dim is cut over."""
        if self.replicated:
            return ()
        return ("data", "model") if self.flat else ("model",)

    @property
    def nb(self) -> int:
        """The number of blocks the batch is cut into."""
        return math.prod(self.mesh.shape[a] for a in self.batch_axes)

    @property
    def n(self) -> int:
        return math.prod(self.mesh.shape[a] for a in self.tp)

    @property
    def r(self) -> int:
        return self.mesh.index_over(self.tp)

    @property
    def group(self):
        return self.mesh.group(self.tp)


# ---------------------------------------------------------------------------
# collectives and blocks
# ---------------------------------------------------------------------------
# A collective is one call over the process group of its axes
# (``Mesh.group``), as ``launch.train``'s are.  A group's members are its
# ranks in ascending order (``Mesh.ranks_over``): their row-major index
# over its axes in mesh order, the order a spec cuts blocks in.

def _reduce_(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``x`` summed (or maxed) over ``group``, in place when contiguous."""
    x = x.contiguous()
    dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                    group=group)
    return x


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _reduce_scatter(parts: list, group) -> torch.Tensor:
    """The sum over ``group`` of each member's ``parts``, the rank's own
    part of it (``parts[i]`` goes to member i); gloo reduces CPU tensors,
    so a card's are staged through the host."""
    dev = parts[0].device
    if parts[0].is_cuda and dist.get_backend(group) == "gloo":
        parts = [t.cpu() for t in parts]
    parts = [t.contiguous() for t in parts]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out.to(dev)


def _own_block(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    b = t.shape[dim] // n
    return t.narrow(dim, dist.get_rank(group) * b, b)


# Megatron's pairs: each op's backward is its forward's transpose over the
# group, so a rank's gradient of a replicated tensor is the whole one and
# of a rank-specific tensor its own.

class _Sum(torch.autograd.Function):
    """The group's sum; the backward is the identity (the sum is replicated,
    so its gradient is the same on every member)."""

    @staticmethod
    def forward(ctx, x, group):
        return _reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    """The identity where a tensor that is the same on every member enters
    rank-specific work; the backward sums the members' partial gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce_(g.clone(memory_format=torch.contiguous_format), ctx.group), None


class _Gather(torch.autograd.Function):
    """The members' blocks concatenated along ``dim`` into a replicated
    tensor; the backward takes the rank's own block."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _own_block(g, ctx.group, ctx.dim), None, None


class _GatherShards(torch.autograd.Function):
    """FSDP's gather of a weight's blocks over ``data``, whose members hold
    other rows of the batch: the backward sums their gradients and hands
    each its own block (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        return _reduce_scatter(list(g.chunk(n, ctx.dim)), ctx.group), None, None


def _all_reduce(x: torch.Tensor, mesh, axes: Sequence[str],
                op: str = "sum") -> torch.Tensor:
    """The sum (or the max, ``op="max"``) of ``x`` over the ranks of ``axes``.
    A sum that autograd records is ``_Sum``: its backward is the identity."""
    group = mesh.group(axes)
    if group is None:
        return x
    if op == "sum" and x.requires_grad and torch.is_grad_enabled():
        return _Sum.apply(x, group)
    return _reduce_(x, group, op)


def _copy(par: "Par", x: torch.Tensor) -> torch.Tensor:
    """``x`` (the same on every rank of ``par.tp``) as the input of the
    rank's own share of some work: its gradient is summed over the group."""
    group = par.group
    if group is None or not (x.requires_grad and torch.is_grad_enabled()):
        return x
    return _Copy.apply(x, group)


def _all_gather(x: torch.Tensor, mesh, axes: Sequence[str], dim: int, *,
                shards: bool = False) -> torch.Tensor:
    """The blocks of ``x`` over the ranks of ``axes`` (in mesh order),
    concatenated along ``dim`` in the members' order.  Under autograd the
    backward takes the rank's block of the gradient, summed over the
    group first when the members' gradients differ (``shards``: FSDP)."""
    group = mesh.group(axes)
    if group is None:
        return x
    if x.requires_grad and torch.is_grad_enabled():
        return (_GatherShards if shards else _Gather).apply(x, group, dim)
    return _gather(x, group, dim)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """x (n, ...): part j to member j; returns what each member sent here,
    by member.  gloo takes CPU tensors for it: a card's are staged."""
    dev = x.device
    if x.is_cuda and dist.get_backend(group) == "gloo":
        x = x.cpu()
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out.to(dev)


class Blocks:
    """A rank's blocks of a set of leaves, read by path.  Under FSDP a leaf
    cut over ``data`` is all-gathered over ``data`` where it is read: one
    block of one leaf (one depth slice of a stack), dropped with the
    caller's reference."""

    def __init__(self, par: Par, tensors: Mapping[str, torch.Tensor],
                 specs: Mapping[str, tuple]):
        self.par, self.tensors, self.specs = par, tensors, specs

    def __getitem__(self, path: str) -> torch.Tensor:
        x = self.tensors[path]
        if self.par.fsdp:
            for dim, e in enumerate(self.specs[path]):
                if e == FSDP:
                    x = _all_gather(x, self.par.mesh, (FSDP,), dim, shards=True)
        return x

    def __contains__(self, path: str) -> bool:
        return path in self.tensors

    def __bool__(self) -> bool:
        return bool(self.tensors)

    def sub(self, prefix: str) -> "Blocks":
        n = len(prefix)
        keys = [k for k in self.tensors if k.startswith(prefix)]
        return Blocks(self.par, {k[n:]: self.tensors[k] for k in keys},
                      {k[n:]: self.specs[k] for k in keys})

    def depth(self) -> int:
        return next(iter(self.tensors.values())).shape[0]

    def layer(self, i: int) -> "Blocks":
        return Blocks(self.par, {k: v[i] for k, v in self.tensors.items()},
                      {k: s[1:] for k, s in self.specs.items()})


def _part(par: Par, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """This rank's share of x @ W, where ``w`` holds rows of W (a slice of
    its contracting dim): x's matching slice (``x`` may be that slice
    already) times ``w``."""
    k = w.shape[-2]
    if x.shape[-1] != k:
        x = x[..., par.r * k:(par.r + 1) * k]
    return x @ w


def _rows(par: Par, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A row-parallel projection: the group's sum of the shares."""
    return _all_reduce(_part(par, x, w), par.mesh, par.tp)


def _proj(par: Par, x: torch.Tensor, ws: Sequence[torch.Tensor], *,
          cols: bool = True) -> list:
    """x @ W for each weight of ``ws``, ``x`` replicated over the group.
    Flat: every ``w`` holds rows, and every output is whole, from one
    fused ``all_reduce``.  Otherwise ``x @ w``: the rank's columns of
    column-parallel weights (``cols``: ``x`` enters them through
    ``_copy``), or all of replicated ones (``cols=False``)."""
    if not par.flat:
        if cols:
            x = _copy(par, x)
        return [x @ w for w in ws]
    parts = [_part(par, x, w) for w in ws]
    widths = [p.shape[-1] for p in parts]
    return list(torch.split(_all_reduce(torch.cat(parts, -1), par.mesh, par.tp),
                            widths, -1))


def _local(par: Par, t: torch.Tensor, full: int, dim: int = -1) -> torch.Tensor:
    """The rank's block of ``t`` along ``dim`` when ``t`` is whole there
    (size ``full``, the same on every rank: it enters through ``_copy``);
    ``t`` itself when it holds that block already."""
    if t.shape[dim] != full or par.n == 1:
        return t
    b = full // par.n
    return _copy(par, t).narrow(dim, par.r * b, b)


def _whole(par: Par, t: torch.Tensor, full: int, dim: int = -1) -> torch.Tensor:
    """``t`` whole along ``dim``: gathered over the group when it holds
    the rank's block only (the backward takes the block back)."""
    return t if t.shape[dim] == full else _all_gather(t, par.mesh, par.tp, dim)


def _seq(par: Par, entry, n_loc: int) -> tuple:
    """(axes, first global index, global size) of a cache dim cut as
    ``entry`` (the spec's entry) with ``n_loc`` entries on this rank."""
    axes = _entry_axes(entry)
    n = math.prod(par.mesh.shape[a] for a in axes)
    return axes, par.mesh.index_over(axes) * n_loc, n * n_loc


# ---------------------------------------------------------------------------
# embedding and head (vocab-parallel)
# ---------------------------------------------------------------------------

def embed(par: Par, table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of a V-sharded table: tokens outside the rank's range give
    zeros, and the group's sum gives every row once."""
    v_loc = table.shape[0]
    if v_loc == par.cfg.padded_vocab:
        return table[tokens]
    idx = tokens - par.r * v_loc
    own = (idx >= 0) & (idx < v_loc)
    x = torch.where(own[..., None], table[idx.clamp(0, v_loc - 1)], 0.0)
    return _all_reduce(x.to(table.dtype), par.mesh, par.tp)


def _head(par: Par, P: Blocks, h: torch.Tensor) -> torch.Tensor:
    """Whole logits over the padded vocabulary: the tied V-sharded
    embedding or the head, gathered over V (or, flat's untied head,
    summed over its contracting dim)."""
    if par.cfg.tie_embeddings:
        y = h @ P["embed"].T
    else:
        y = _proj(par, h, [P["lm_head"]])[0]
    return _whole(par, y, par.cfg.padded_vocab)


# ---------------------------------------------------------------------------
# attention over the sequence-sharded cache (decode)
# ---------------------------------------------------------------------------

def _softmax(par: Par, scores: torch.Tensor, axes) -> torch.Tensor:
    """Softmax over the last dim, cut over ``axes``: the global row
    maximum, then the global sum of the exponentials."""
    m = _all_reduce(scores.amax(-1, keepdim=True), par.mesh, axes, "max")
    e = torch.exp(scores - m)
    return e / _all_reduce(e.sum(-1, keepdim=True), par.mesh, axes)


def _ring_local(pos: torch.Tensor, Sc: int, s0: int, n_loc: int, window: int = 0):
    """The slot ``pos`` writes as a local index (clamped), whether this
    rank owns it, and the validity of the rank's slots [s0, s0 + n_loc)
    (``layers._ring`` on global slot indices)."""
    slot, valid = L._ring(pos, Sc, window)
    loc = slot - s0
    own = (loc >= 0) & (loc < n_loc)
    return loc.clamp(0, n_loc - 1), own, valid[s0:s0 + n_loc]


def _write(c: torch.Tensor, slot: torch.Tensor, own: torch.Tensor,
           new: torch.Tensor) -> None:
    """Write ``new`` (B, 1, ...) into slot ``slot`` of ``c`` (B, S_loc, ...)
    where this rank owns it; elsewhere write back what is there."""
    cur = c.index_select(1, slot)
    c.index_copy_(1, slot, torch.where(own, new.to(c.dtype), cur))


def attention_decode(par: Par, p: Blocks, x: torch.Tensor, pos: torch.Tensor,
                     cache: dict, seq_entry, *, window: int = 0) -> torch.Tensor:
    """``layers.attention_decode`` on the rank's blocks: x (B, 1, D)
    replicated over the group, the cache's ``k``/``v`` (B, Sc_loc, Hk, hd)
    cut over the sequence as ``seq_entry``.  Returns (B, 1, D)."""
    cfg = par.cfg
    B = x.shape[0]
    H, Hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q, k, v = _proj(par, x, [p["wq"], p["wk"], p["wv"]])
    if cfg.attn_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = _whole(par, q, H * hd).reshape(B, 1, H, hd)
    k, v = _whole(par, torch.stack([k, v]), Hk * hd).reshape(2, B, 1, Hk, hd)
    if cfg.pos_kind in ("rope", "mrope"):
        cos, sin = L.rope_cos_sin(
            cfg, pos.expand((3, B, 1) if cfg.pos_kind == "mrope" else (B, 1)), hd)
        q = L.apply_rope(q, cos, sin)
        k = L.apply_rope(k, cos, sin)
    ck, cv = cache["k"], cache["v"]
    axes, s0, Sc = _seq(par, seq_entry, ck.shape[1])
    slot, own, valid = _ring_local(pos, Sc, s0, ck.shape[1], window)
    _write(ck, slot, own, k)
    _write(cv, slot, own, v)
    qg = q.reshape(B, Hk, H // Hk, hd)
    scores = torch.einsum("bkgh,btkh->bkgt", qg, ck.to(q.dtype))
    scores = scores.to(torch.float32) / L._sqrt32(hd, x.device)
    scores = torch.where(valid, scores, -1e30)
    probs = _softmax(par, scores, axes).to(cv.dtype)
    out = _all_reduce(torch.einsum("bkgt,btkh->bkgh", probs, cv), par.mesh, axes)
    return _rows(par, out.reshape(B, 1, H * hd), p["wo"])


def cross_attention_decode(par: Par, p: Blocks, x: torch.Tensor, cache: dict,
                           seq_entry) -> torch.Tensor:
    """``layers.cross_attention_decode`` against the rank's block of the
    encoder's ``xk``/``xv`` (cut over the encoder sequence as
    ``seq_entry``): no rotary, no mask, no query bias."""
    cfg = par.cfg
    B = x.shape[0]
    H, Hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = _whole(par, _proj(par, x, [p["wq"]])[0], H * hd)
    qg = q.reshape(B, Hk, H // Hk, hd)
    axes = _seq(par, seq_entry, cache["xk"].shape[1])[0]
    scores = torch.einsum("bkgh,btkh->bkgt", qg, cache["xk"].to(qg.dtype))
    scores = scores.to(torch.float32) / L._sqrt32(hd, x.device)
    probs = _softmax(par, scores, axes).to(x.dtype)
    out = _all_reduce(torch.einsum("bkgt,btkh->bkgh", probs,
                                   cache["xv"].to(x.dtype)), par.mesh, axes)
    return _rows(par, out.reshape(B, 1, H * hd), p["wo"])


def mla_attention_decode(par: Par, p: Blocks, x: torch.Tensor, pos: torch.Tensor,
                         cache: dict, seq_entry) -> torch.Tensor:
    """``layers.mla_attention_decode`` (the absorbed form) against the
    rank's sequence block of ``ckv``/``kpe``.  The absorbed query
    (q_tilde, q_pe) is gathered whole: over the heads (default) or over
    the latent rank (flat, where ``w_uk`` is cut over it); after the
    merge, the rank's heads go through ``w_uv`` (or its latent rows,
    summed) and the row-parallel ``wo``."""
    cfg = par.cfg
    B = x.shape[0]
    H = cfg.num_heads
    nope, rdim, vdim = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    cq, ckv_t, kpe_t = _proj(par, x, [p["w_dq"], p["w_dkv"], p["w_kr"]], cols=False)
    q = _proj(par, cq, [p["w_uq"]])[0]
    Hq = q.shape[-1] // (nope + rdim)
    q = q.reshape(B, Hq, nope + rdim)
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    cos, sin = L.rope_cos_sin(cfg, pos.expand(B, 1), rdim)
    q_pe = L.apply_rope(q_pe.reshape(B, 1, Hq, rdim), cos, sin).reshape(B, Hq, rdim)
    kpe_t = L.apply_rope(kpe_t.reshape(B, 1, 1, rdim), cos, sin).reshape(B, 1, rdim)
    ckv, kpe = cache["ckv"], cache["kpe"]
    axes, s0, Sc = _seq(par, seq_entry, ckv.shape[1])
    slot, own, valid = _ring_local(pos, Sc, s0, ckv.shape[1])
    _write(ckv, slot, own, ckv_t)
    _write(kpe, slot, own, kpe_t)
    wuk = p["w_uk"]
    q_tilde = torch.einsum("bhn,rhn->bhr", q_nope, wuk.reshape(wuk.shape[0], Hq, nope))
    q_tilde = _whole(par, q_tilde, kvr)
    qa = _whole(par, torch.cat([q_tilde, q_pe], -1), H, dim=1)
    q_tilde, q_pe = qa[..., :kvr], qa[..., kvr:]
    scores = (torch.einsum("bhr,btr->bht", q_tilde, ckv.to(q_tilde.dtype))
              + torch.einsum("bhr,btr->bht", q_pe, kpe.to(q_pe.dtype)))
    scores = scores.to(torch.float32) / L._sqrt32(nope + rdim, x.device)
    scores = torch.where(valid, scores, -1e30)
    probs = _softmax(par, scores, axes).to(x.dtype)
    attn_c = _all_reduce(torch.einsum("bht,btr->bhr", probs, ckv.to(x.dtype)),
                         par.mesh, axes)
    wuv = p["w_uv"]
    if wuv.shape[0] != kvr:            # flat: w_uv's latent rows on this rank
        out = _all_reduce(torch.einsum("bhr,rhv->bhv", _local(par, attn_c, kvr),
                                       wuv.reshape(-1, H, vdim)), par.mesh, par.tp)
    else:                              # the rank's heads
        out = torch.einsum("bhr,rhv->bhv", _local(par, attn_c, H, dim=1),
                           wuv.reshape(kvr, -1, vdim))
    return _rows(par, out.reshape(B, 1, -1), p["wo"])


# ---------------------------------------------------------------------------
# full-sequence attention (prefill and the encoder): the rank's heads
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HeadPlan:
    """The whole heads one rank attends over in a full-sequence attention
    (``head_plan``): query heads [q0, q1), the key/value heads ``kv`` it
    reads (global indices, in order), their grouping ``num_kv`` for
    ``layers._attend_chunked``, and which of q and k/v are gathered whole
    over the group first.  ``starts[j]`` is member j's first query head
    when q is gathered (its heads end at ``starts[j + 1]``)."""
    q0: int
    q1: int
    kv: tuple[int, ...]
    num_kv: int
    gather_q: bool = False
    gather_kv: bool = False
    starts: tuple[int, ...] = ()

    @property
    def whole(self) -> bool:
        """The rank's own columns are whole heads: no collective added."""
        return not (self.gather_q or self.gather_kv)


def head_plan(cfg, q_cols: int, k_cols: int, n: int, r: int) -> HeadPlan:
    """The heads rank ``r`` of ``n`` attends over, its q and k/v columns
    being ``q_cols`` and ``k_cols`` wide (the column-parallel cut of
    ``wq``/``wk``; every column under the flat layout).

    * Whole heads: the rank's own heads, nothing gathered.
    * Key/value heads cut, query heads whole: k and v gathered; the rank
      keeps the kv heads its query heads read (query head i reads kv head
      i // (H / Hkv), the reference's ``jnp.repeat``).
    * Query heads cut (then so are the kv heads): q, k and v gathered; the
      rank takes heads [r H // n, (r + 1) H // n), so no head is computed
      twice and none is left out.

    Where the kv heads a rank reads are not an even grouping of its query
    heads, ``kv`` repeats one per query head (``num_kv`` = its heads)."""
    H, Hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    if q_cols % hd == 0 and k_cols % hd == 0:
        hq, hk = q_cols // hd, k_cols // hd
        q0 = 0 if hq == H else r * hq
        k0 = 0 if hk == Hk else r * hk
        return HeadPlan(q0, q0 + hq, tuple(range(k0, k0 + hk)), hk)
    gather_q = q_cols % hd != 0
    starts = tuple(j * H // n for j in range(n + 1)) if gather_q else ()
    q0, q1 = (starts[r], starts[r + 1]) if gather_q else (r * (q_cols // hd),
                                                          (r + 1) * (q_cols // hd))
    reads = [i // (H // Hk) for i in range(q0, q1)]
    kv = sorted(set(reads))
    if kv and all(reads.count(k) * len(kv) == len(reads) for k in kv):
        return HeadPlan(q0, q1, tuple(kv), len(kv), gather_q, True, starts)
    return HeadPlan(q0, q1, tuple(reads), max(len(reads), 1), gather_q, True, starts)


def _gather_heads(par: Par, plan: HeadPlan, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> tuple:
    """q (B, S, Hq_loc, hd) and k, v (B, T, len(kv), hd) of the rank's
    heads from its columns: the columns the plan gathers go in ONE
    all_gather over the group (flattened, laid end to end), whose
    backward is a reduce-scatter (each member reads its own heads of
    them), then each member's block is put back in place."""
    B, S = q.shape[:2]
    hd = par.cfg.hd
    parts = ([q] if plan.gather_q else []) + [k, v]
    every = _all_gather(torch.cat([t.reshape(-1) for t in parts])[None],
                        par.mesh, par.tp, 0, shards=True)
    whole, off = [], 0
    for t in parts:
        blk = every[:, off:off + t.numel()].reshape(par.n, *t.shape)
        whole.append(blk.movedim(0, -2).reshape(*t.shape[:-1], par.n * t.shape[-1]))
        off += t.numel()
    if plan.gather_q:
        q = whole.pop(0)[..., plan.q0 * hd:plan.q1 * hd]
    idx = torch.tensor(plan.kv, dtype=torch.int64, device=q.device)
    k, v = (t.reshape(*t.shape[:2], -1, hd).index_select(2, idx) for t in whole)
    return q.reshape(B, S, plan.q1 - plan.q0, hd), k, v


def _wo_cols(par: Par, plan: HeadPlan, out: torch.Tensor) -> torch.Tensor:
    """(B, S, heads of the rank x hd) -> the rank's H hd / n columns, the
    cut ``wo``'s rows have: every member's heads padded to the most a
    member has, one all_gather over the group (a reduce-scatter in the
    backward), and the rank's columns picked out of it."""
    hd, n, r = par.cfg.hd, par.n, par.r
    st = plan.starts
    most = max(st[j + 1] - st[j] for j in range(n)) * hd
    every = _all_gather(F.pad(out, (0, most - out.shape[-1]))[None],
                        par.mesh, par.tp, 0, shards=True)       # (n, B, S, most)
    width = st[n] * hd // n
    cols = []
    for c in range(r * width, (r + 1) * width):
        j = bisect.bisect_right(st, c // hd) - 1      # the member that computed head c // hd
        cols.append(j * most + c - st[j] * hd)
    flat = every.movedim(0, -2).reshape(*out.shape[:-1], n * most)
    return flat.index_select(-1, torch.tensor(cols, dtype=torch.int64, device=out.device))


def attention(par: Par, p: Blocks, x: torch.Tensor, positions: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              enc_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``layers.attention`` over the heads ``head_plan`` gives the rank
    (its own, all of them under the flat layout, or, where its columns
    are not whole heads, whole heads gathered: rotary on whole heads),
    then the row-parallel ``wo`` on the rank's rows."""
    cfg = par.cfg
    B, S, _ = x.shape
    hd = cfg.hd
    if enc_out is None:
        q, k, v = _proj(par, x, [p["wq"], p["wk"], p["wv"]])
    else:
        q = _proj(par, x, [p["wq"]])[0]
        k, v = _proj(par, enc_out, [p["wk"], p["wv"]])
    if cfg.attn_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    plan = head_plan(cfg, q.shape[-1], k.shape[-1], par.n, par.r)
    T = k.shape[1]
    if plan.whole:
        q = q.reshape(B, S, -1, hd)
        k = k.reshape(B, T, -1, hd)
        v = v.reshape(B, T, -1, hd)
    else:
        q, k, v = _gather_heads(par, plan, q, k, v)
    if cfg.pos_kind in ("rope", "mrope") and enc_out is None:
        cos, sin = L.rope_cos_sin(cfg, positions, hd)
        q = L.apply_rope(q, cos, sin)
        k = L.apply_rope(k, cos, sin)
    out = L._attend_chunked(q, k, v, causal=causal and enc_out is None,
                            window=window, q_offset=0, num_kv=plan.num_kv)
    out = out.reshape(B, S, (plan.q1 - plan.q0) * hd)
    if plan.gather_q:
        out = _wo_cols(par, plan, out)
    return _rows(par, out, p["wo"])


def mla_attention(par: Par, p: Blocks, x: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    """``layers.mla_attention`` (unabsorbed) over the rank's heads: the
    replicated down-projections, then ``cq``, ``ckv`` and the shared rotary
    key ``k_pe`` into the rank's heads."""
    cfg = par.cfg
    B, S, _ = x.shape
    nope, rdim, vdim = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    cq, ckv, k_pe = _proj(par, x, [p["w_dq"], p["w_dkv"], p["w_kr"]], cols=False)
    q = _proj(par, cq, [p["w_uq"]])[0]
    k_nope, v = _proj(par, ckv, [p["w_uk"], p["w_uv"]])
    Hq = q.shape[-1] // (nope + rdim)
    q = q.reshape(B, S, Hq, nope + rdim)
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    k_pe = _copy(par, k_pe).reshape(B, S, 1, rdim)
    k_nope = k_nope.reshape(B, S, Hq, nope)
    v = v.reshape(B, S, Hq, vdim)
    cos, sin = L.rope_cos_sin(cfg, positions, rdim)
    q_pe = L.apply_rope(q_pe, cos, sin)
    k_pe = L.apply_rope(k_pe, cos, sin)
    q_full = torch.cat([q_nope, q_pe], dim=-1)
    k_full = torch.cat([k_nope, k_pe.expand(B, S, Hq, rdim)], dim=-1)
    out = L._attend_chunked(q_full, k_full, v, causal=True, window=0,
                            q_offset=0, num_kv=Hq)
    return _rows(par, out.reshape(B, S, Hq * vdim), p["wo"])


# ---------------------------------------------------------------------------
# MLP, MoE (experts over the group), Mamba (d_inner over the group)
# ---------------------------------------------------------------------------

def mlp(par: Par, p: Blocks, x: torch.Tensor) -> torch.Tensor:
    """``layers.mlp``: the rank's d_ff columns, the row-parallel ``wo``."""
    cfg = par.cfg
    if cfg.mlp_kind == "gelu":
        h = _local(par, _proj(par, x, [p["wi"]])[0], cfg.d_ff)
        if "bi" in p:
            h = h + _local(par, p["bi"], cfg.d_ff)
        h = F.gelu(h, approximate="tanh")
    else:
        g, i = _proj(par, x, [p["wg"], p["wi"]])
        h = F.silu(_local(par, g, cfg.d_ff)) * _local(par, i, cfg.d_ff)
    return _rows(par, h, p["wo"])


def _moe_offsets(par: Par, topi: torch.Tensor, t0: int, tc: int,
                 n_chunks: int) -> torch.Tensor:
    """(n_chunks, E): the slots the batch's earlier data shards take in
    each token chunk, by expert -- an exclusive prefix over every shard's
    counts, from one all_gather."""
    E, k = par.cfg.num_experts, par.cfg.moe_top_k
    T = topi.shape[0]
    chunk = ((t0 + torch.arange(T, device=topi.device)) // tc).repeat_interleave(k)
    counts = torch.zeros((n_chunks, E), dtype=torch.int64, device=topi.device)
    counts.index_put_((chunk, topi.reshape(-1)), torch.ones_like(chunk), accumulate=True)
    every = _all_gather(counts[None], par.mesh, par.batch_axes, 0)
    return every[:par.mesh.index_over(par.batch_axes)].sum(0)


def moe(par: Par, p: Blocks, x: torch.Tensor, *, aux: bool = False):
    """``layers.moe`` with the experts cut over the group: the replicated
    (or, flat, row-summed) float32 router, each choice's slot in the
    global batch's (token, choice) order within each ``MOE_CHUNK`` and the
    capacity of the global token count, the rank's experts on the choices
    routed to them, the shared expert's share, one ``all_reduce``.  The
    tokens and the top-k weights enter the rank's experts through
    ``_copy``.  Returns (out, the load-balance aux loss or None): with
    ``aux``, its ``me``/``ce`` are means over the whole batch, one
    ``all_reduce`` of the rank's sums over the batch axes (identity in the
    backward), so the term is the same on every rank."""
    cfg = par.cfg
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.moe_top_k
    T = B * S
    xf = x.reshape(T, D)
    probs = torch.softmax(_proj(par, xf, [p["router"]], cols=False)[0]
                          .to(torch.float32), dim=-1)
    topw, topi = torch.topk(probs, k, dim=-1)
    topw = topw / (torch.sum(topw, dim=-1, keepdim=True) + 1e-9)
    nb = par.nb
    loss = None
    if aux:
        sums = torch.cat([probs.sum(0), F.one_hot(topi[:, 0], E).to(torch.float32).sum(0)])
        sums = _all_reduce(sums, par.mesh, par.batch_axes) / (T * nb)
        loss = cfg.router_aux_weight * E * torch.sum(sums[:E] * sums[E:])
    t0 = par.mesh.index_over(par.batch_axes) * T          # first global token
    tc, cap = L.moe_capacity(cfg, T * nb)
    # with cap >= tc no expert fills in a chunk: the earlier shards' slots
    # move rows of the dispatch buffer, and no result (decode at B <= 8)
    offsets = (_moe_offsets(par, topi, t0, tc, -(-T * nb // tc))
               if nb > 1 and cap < tc else None)
    w = {name: p[name] for name in ("wi", "wg", "wo")}
    e_loc = w["wi"].shape[0]
    e0 = par.r * e_loc if e_loc != E else 0
    n_rows = e_loc * cap
    xc, topw = (_copy(par, t) for t in (xf, topw))
    outs = []
    for g0 in range(t0 // tc * tc, t0 + T, tc):
        a, b = max(g0, t0) - t0, min(g0 + tc, t0 + T) - t0
        fi = topi[a:b].reshape(-1)
        pos_mat = torch.cumsum(F.one_hot(fi, E).to(torch.int32), dim=0) - 1
        posn = torch.gather(pos_mat, 1, fi[:, None])[:, 0]
        if offsets is not None:
            posn = posn + offsets[g0 // tc][fi]
        keep = (posn < cap) & (fi >= e0) & (fi < e0 + e_loc)
        slot = torch.where(keep, (fi - e0) * cap + posn, n_rows)
        xrep = torch.repeat_interleave(xc[a:b], k, dim=0)
        buf = torch.zeros((n_rows + 1, D), dtype=x.dtype,
                          device=x.device).index_add(0, slot, xrep)
        ye = L._expert_ffn(w, buf[:n_rows].reshape(e_loc, cap, D))
        yrep = ye.reshape(n_rows, D)[torch.clamp(slot, 0, n_rows - 1)]
        yrep = torch.where(keep[:, None], yrep, 0.0)
        yrep = yrep * topw[a:b].reshape(-1)[:, None].to(x.dtype)
        outs.append(yrep.reshape(b - a, k, D).sum(dim=1))
    out = torch.cat(outs)
    if cfg.num_shared_experts:
        fs = cfg.moe_ff * cfg.num_shared_experts
        g, i = _proj(par, xc, [p["shared/wg"], p["shared/wi"]], cols=False)
        h = F.silu(_local(par, g, fs)) * _local(par, i, fs)
        out = out + _part(par, h, p["shared/wo"])
    return _all_reduce(out, par.mesh, par.tp).reshape(B, S, D), loss


def _mamba_in(par: Par, p: Blocks, x: torch.Tensor):
    """The rank's d_inner columns of x @ wx and x @ wz, and its blocks of
    the per-channel weights."""
    di = par.cfg.d_inner
    u, z = (_local(par, t, di) for t in _proj(par, x, [p["wx"], p["wz"]]))
    ch = {name: _local(par, p[name], di, dim=0 if name == "a_log" else -1)
          for name in ("conv_w", "conv_b", "dt_bias", "a_log", "d_skip")}
    return u, z, ch


def _mamba_dt(par: Par, p: Blocks, ch: dict, u: torch.Tensor):
    """(dt, B, C) from the rank's channels: the row-parallel ``x_proj``
    summed whole (all of it feeds the rank's channels: one ``_copy``),
    then the rank's d_inner columns of ``dt_proj``."""
    cfg = par.cfg
    dtr, ds = cfg.dt_rank, cfg.ssm_state
    xdb = _copy(par, _rows(par, u, p["x_proj"]))
    dt = _local(par, _proj(par, xdb[..., :dtr], [p["dt_proj"]], cols=False)[0],
                cfg.d_inner)
    dt = F.softplus(dt + ch["dt_bias"])
    return dt, xdb[..., dtr:dtr + ds], xdb[..., dtr + ds:]


def mamba(par: Par, p: Blocks, x: torch.Tensor) -> torch.Tensor:
    """``layers.mamba`` on the rank's d_inner channels: the conv, the scan
    and the skip are per channel; ``x_proj`` and ``out_proj`` are
    row-parallel."""
    cfg = par.cfg
    B, S, _ = x.shape
    kw = cfg.ssm_conv
    u, z, ch = _mamba_in(par, p, x)
    upad = F.pad(u, (0, 0, kw - 1, 0))
    conv = 0
    for i in range(kw):
        conv = conv + upad[:, i:i + S] * ch["conv_w"][i]
    u = F.silu(conv + ch["conv_b"])
    dt, Bs, Cs = _mamba_dt(par, p, ch, u)
    Cs = Cs.to(torch.float32)
    A = -torch.exp(ch["a_log"].to(torch.float32))
    a = torch.exp(dt[..., None].to(torch.float32) * A)
    b = (dt[..., None] * Bs[:, :, None, :] * u[..., None]).to(torch.float32)
    h = torch.zeros((B, u.shape[-1], cfg.ssm_state), dtype=torch.float32,
                    device=x.device)
    ys = []
    for c0 in range(0, S, L.MAMBA_CHUNK):
        hs = []
        for t in range(c0, min(c0 + L.MAMBA_CHUNK, S)):
            h = a[:, t] * h + b[:, t]
            hs.append(h)
        ys.append(torch.einsum("blds,bls->bld", torch.stack(hs, dim=1),
                               Cs[:, c0:c0 + len(hs)]))
    y = (torch.cat(ys, dim=1) + u.to(torch.float32) * ch["d_skip"]).to(x.dtype)
    return _rows(par, y * F.silu(z), p["out_proj"])


def mamba_decode(par: Par, p: Blocks, x: torch.Tensor, cache: dict) -> torch.Tensor:
    """``layers.mamba_decode`` on the rank's d_inner channels, whose state
    ``h`` (B, di_loc, ds) and conv window (B, kw - 1, di_loc) the rank
    holds; both updated in place.  Returns (B, 1, D)."""
    B = x.shape[0]
    u, z, ch = _mamba_in(par, p, x)
    u, z = u.reshape(B, -1), z.reshape(B, -1)
    win = torch.cat([cache["conv"], u[:, None]], dim=1)
    u = F.silu(torch.einsum("bkd,kd->bd", win, ch["conv_w"]) + ch["conv_b"])
    dt, Bs, Cs = _mamba_dt(par, p, ch, u)
    A = -torch.exp(ch["a_log"].to(torch.float32))
    a = torch.exp(dt[..., None].to(torch.float32) * A)
    hb = dt[..., None] * Bs[:, None, :] * u[..., None]
    h = a * cache["h"] + hb.to(torch.float32)
    y = torch.einsum("bds,bs->bd", h, Cs.to(torch.float32))
    y = (y + u.to(torch.float32) * ch["d_skip"]).to(x.dtype)
    cache["h"].copy_(h)
    cache["conv"].copy_(win[:, 1:])
    return _rows(par, y * F.silu(z), p["out_proj"])[:, None, :]


# ---------------------------------------------------------------------------
# blocks, the forward (prefill), the encoder and the decode step
# ---------------------------------------------------------------------------

def _apply_block(par: Par, pattern, blk: Blocks, x: torch.Tensor,
                 positions: torch.Tensor, *, enc_out: Optional[torch.Tensor] = None,
                 bidirectional: bool = False, aux: bool = False):
    """``model._apply_block`` on the rank's blocks: (x, the MoE layers' aux
    loss, or None without ``aux``)."""
    cfg = par.cfg
    total = None
    for i, (mixer, mlp_kind) in enumerate(pattern):
        sub = blk.sub(f"l{i}/")
        if mixer == "attn":
            p = sub.sub("attn/")
            h = L.apply_norm(cfg, p.sub("ln/"), x)
            if cfg.mla:
                h = mla_attention(par, p, h, positions)
            else:
                h = attention(par, p, h, positions, causal=not bidirectional,
                              window=cfg.sliding_window)
            x = x + h
            xp = sub.sub("xattn/")
            if enc_out is not None and xp:
                h = L.apply_norm(cfg, xp.sub("ln/"), x)
                x = x + attention(par, xp, h, positions, enc_out=enc_out)
        else:
            p = sub.sub("mamba/")
            x = x + mamba(par, p, L.apply_norm(cfg, p.sub("ln/"), x))
        if mlp_kind == "dense":
            p = sub.sub("mlp/")
            x = x + mlp(par, p, L.apply_norm(cfg, p.sub("ln/"), x))
        elif mlp_kind == "moe":
            p = sub.sub("moe/")
            h, a = moe(par, p, L.apply_norm(cfg, p.sub("ln/"), x), aux=aux)
            x = x + h
            if aux:
                total = a if total is None else total + a
    return x, total


def _run_blocks(par: Par, pattern, P: Blocks, prefix: str, x: torch.Tensor,
                positions: torch.Tensor, *, remat: bool = True, **kw):
    """Every block of the stack under ``prefix``: (x, the summed aux loss).
    Under ``remat`` each block is recomputed in the backward
    (``model.remat_block``), its collectives with it, on every rank in the
    same order: the forward sums, the part-head gathers, FSDP's gathers of
    the block's weights (``Blocks`` keeps none) and the MoE group's calls,
    up to the block's last saved activation."""
    stack = P.sub(prefix)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in range(stack.depth()):
        x, a = remat_block(remat, _apply_block, par, pattern, stack.layer(layer), x,
                           positions, **kw)
        if a is not None:
            aux = aux + a
    return x, aux


def _encode(par: Par, P: Blocks, audio: torch.Tensor, *,
            remat: bool = True) -> torch.Tensor:
    """The audio encoder's normed output (replicated over the group)."""
    cfg = par.cfg
    B, Te, _ = audio.shape
    dev = audio.device
    e = audio + L.sinusoidal_embed(torch.arange(Te, device=dev),
                                   cfg.d_model)[None].to(audio.dtype)
    e, _ = _run_blocks(par, DENSE, P, "enc_layers/", e, _positions_for(cfg, B, Te, dev),
                       bidirectional=True, remat=remat)
    return L.apply_norm(cfg, P.sub("enc_norm/"), e)


def _forward(par: Par, P: Blocks, batch: Mapping[str, torch.Tensor], *,
             aux: bool = False, remat: bool = True):
    """``model.forward`` on the rank's blocks and its rows of the batch:
    (the hidden states (B_loc, S, D), replicated over the group; the aux
    loss).  ``remat``: ``model.forward``'s."""
    cfg = par.cfg
    tokens = batch["tokens"]
    B = tokens.shape[0]
    dev = tokens.device
    n_blocks, pattern = cfg.scan_blocks()
    x = embed(par, P["embed"], tokens)
    if cfg.frontend == "vision":
        x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    S = x.shape[1]
    positions = _positions_for(cfg, B, S, dev)
    if cfg.pos_kind == "sinusoidal":
        x = x + L.sinusoidal_embed(torch.arange(S, device=dev),
                                   cfg.d_model)[None].to(x.dtype)
    enc_out = None
    if cfg.encoder_layers:
        enc_out = _encode(par, P, batch["audio_embeds"].to(x.dtype), remat=remat)
    total = torch.zeros((), dtype=torch.float32, device=dev)
    if cfg.first_dense_layers:
        x, a = _run_blocks(par, DENSE, P, "dense_layers/", x, positions, aux=aux,
                           remat=remat)
        total = total + a
    x, a = _run_blocks(par, pattern, P, "layers/", x, positions, enc_out=enc_out,
                       aux=aux, remat=remat)
    return L.apply_norm(cfg, P.sub("final_norm/"), x), total + a


@torch.no_grad()
def forward(par: Par, params: Mapping[str, torch.Tensor],
            batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """``model.forward`` on the rank's blocks and its rows of the batch:
    the hidden states (B_loc, S, D), replicated over the group."""
    return _forward(par, Blocks(par, params, par.pspecs), batch)[0]


@torch.no_grad()
def prefill_logits(par: Par, params: Mapping[str, torch.Tensor],
                   batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The last token's logits, the rank's (B_loc, V_loc) block of the
    padded vocabulary: the reference's ``out_shardings=P(daxes, "model")``."""
    h = forward(par, params, batch)[:, -1]
    P = Blocks(par, params, par.pspecs)
    return h @ (P["embed"].T if par.cfg.tie_embeddings else P["lm_head"])


# ---------------------------------------------------------------------------
# the training loss (vocab-parallel cross-entropy)
# ---------------------------------------------------------------------------

class _VocabCE(torch.autograd.Function):
    """The masked cross-entropy sum of one sequence chunk from the rank's
    (B, Sc, V_loc) float32 logits, columns [v0, v0 + V_loc) of the padded
    vocabulary: the row maximum (detached) by one MAX ``all_reduce``, the
    exponentials' sum and the gold logit (the reference's masked sum over
    the vocabulary) by one SUM; the result is the same on every rank.  The
    backward is ``softmax - onehot`` on the local block."""

    @staticmethod
    def forward(ctx, logits, labels, mask, v0, group):
        m = logits.amax(-1)
        if group is not None:
            m = _reduce_(m, group, "max")
        ids = v0 + torch.arange(logits.shape[-1], device=logits.device)
        gold = torch.sum(torch.where(ids == labels[..., None], logits, 0.0), dim=-1)
        sg = torch.stack([torch.exp(logits - m[..., None]).sum(-1), gold])
        if group is not None:
            sg = _reduce_(sg, group)
        lse = m + torch.log(sg[0])
        ctx.save_for_backward(logits, lse, labels, mask)
        ctx.v0 = v0
        return torch.sum((lse - sg[1]) * mask)

    @staticmethod
    def backward(ctx, g):
        logits, lse, labels, mask = ctx.saved_tensors
        ids = ctx.v0 + torch.arange(logits.shape[-1], device=logits.device)
        grad = torch.exp(logits - lse[..., None])
        grad = grad - (ids == labels[..., None]).to(grad.dtype)
        return grad * (g * mask)[..., None], None, None, None, None


def _ce_sum(par: Par, h: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """``model._ce_loss_chunked``'s numerator, chunked along the sequence by
    ``LOSS_CHUNK``: h (B, S, D) (through ``_copy``) times the rank's
    (D, V_loc) head columns, each chunk's logits only; with the whole
    vocabulary on the rank, the one-process sum, bit for bit."""
    v_loc = head.shape[-1]
    whole = v_loc == par.cfg.padded_vocab
    S = h.shape[1]
    sc = min(LOSS_CHUNK, S)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, S, sc):
        logits = (h[:, c0:c0 + sc] @ head).to(torch.float32)
        lc, mc = labels[:, c0:c0 + sc].long(), mask[:, c0:c0 + sc].to(torch.float32)
        if whole:       # the vocabulary on this rank: model._ce_loss_chunked's sum
            gold = torch.gather(logits, -1, lc[..., None])[..., 0]
            tot = tot + torch.sum((torch.logsumexp(logits, dim=-1) - gold) * mc)
        else:
            tot = tot + _VocabCE.apply(logits, lc, mc, par.r * v_loc, par.group)
    return tot


def _count(par: Par, mask: torch.Tensor) -> torch.Tensor:
    """The client's global count of loss positions (at least 1), float32:
    every batch block's rows carry the same mask."""
    return torch.clamp(torch.sum(mask.to(torch.float32)) * par.nb, min=1.0)


def loss_fn(par: Par, params: Mapping[str, torch.Tensor],
            batch: Mapping[str, torch.Tensor], *,
            remat: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """``model.loss_fn`` on the rank's blocks and its rows of a client's
    batch (the batch cut over ``par.batch_axes``): the next-token loss over
    the padded vocabulary through the vocab-parallel cross-entropy
    (no rank holds (B, S, V)), DeepSeek's MTP term and the MoE aux loss.

    Returns (loss, client_loss).  ``loss`` is the rank's differentiable
    term: its cross-entropy sums over the client's global token count plus
    the aux loss (the same on every rank), so the rank's gradients summed
    over the batch axes are the client loss's gradients.  ``client_loss``
    (detached) is the client's loss, the same on every rank: the rank's
    cross-entropy terms summed over the batch axes (one scalar
    ``all_reduce``), plus the aux loss once.  ``remat`` (the reference's
    default, on) recomputes each block in the backward (``_run_blocks``)."""
    cfg = par.cfg
    if par.flat:
        raise ValueError("the flat layout serves only (as the reference's "
                         "dryrun lays it out); train on the default layout")
    P = Blocks(par, params, par.pspecs)
    tokens = batch["tokens"]
    B, St = tokens.shape
    h, aux = _forward(par, P, batch, aux=bool(cfg.num_experts), remat=remat)
    Pf = cfg.num_frontend_tokens if cfg.frontend == "vision" else 0
    ht = _copy(par, h[:, Pf:])                  # the hidden state that feeds the head
    labels = F.pad(tokens[:, 1:], (0, 1))
    mask = torch.ones((B, St), dtype=torch.bool, device=tokens.device)
    mask[:, -1] = False
    head = P["embed"].T if cfg.tie_embeddings else P["lm_head"]
    ce = _ce_sum(par, ht, head, labels, mask) / _count(par, mask)
    if cfg.mtp:
        labels2 = F.pad(tokens[:, 2:], (0, 2))
        mask2 = torch.ones((B, St), dtype=torch.bool, device=tokens.device)
        mask2[:, -2:] = False
        head2 = P["embed"].T if cfg.tie_embeddings else P["mtp_head"]
        ce = ce + cfg.mtp_weight * (_ce_sum(par, ht, head2, labels2, mask2)
                                    / _count(par, mask2))
    with torch.no_grad():
        client = _all_reduce(ce.detach().clone(), par.mesh, par.batch_axes) + aux.detach()
    return ce + aux, client


def _seq_block(par: Par, y: torch.Tensor, entry, n_loc: int) -> torch.Tensor:
    """(B, Te, width) keys or values of the rank's heads (or all heads) ->
    the rank's block of the encoder sequence with every head, (B, n_loc,
    Hk * hd): a slice when the heads are whole, else one all_to_all over
    the group (heads and sequence cut over the same axes)."""
    B, Te, width = y.shape
    axes = _entry_axes(entry)
    i = par.mesh.index_over(axes)
    if width == par.cfg.num_kv_heads * par.cfg.hd:
        return y[:, i * n_loc:(i + 1) * n_loc]
    if set(axes) != set(par.tp):
        raise ValueError(f"cross-attention cache cut over {axes}, its heads over "
                         f"{par.tp}: no layout of this port")
    n = par.n
    parts = _all_to_all(y.reshape(B, n, n_loc, width).transpose(0, 1), par.group)
    return parts.permute(1, 2, 0, 3).reshape(B, n_loc, n * width)


@torch.no_grad()
def encode_for_decode(par: Par, params: Mapping[str, torch.Tensor], cache: dict,
                      audio: torch.Tensor) -> dict:
    """``model.encode_for_decode`` on the rank's blocks: the encoder on the
    rank's rows, then each decoder block's ``xk``/``xv`` (no bias) into
    the rank's block of the cache, in place."""
    cfg = par.cfg
    P = Blocks(par, params, par.pspecs)
    enc_out = _encode(par, P, audio)
    for path, c in cache.items():
        head, _, leaf = path.rpartition("/")
        if leaf not in ("xk", "xv"):
            continue
        stack = P.sub(f"{head}/xattn/")
        for layer in range(c.shape[0]):
            y = _proj(par, enc_out, [stack.layer(layer)[f"w{leaf[1]}"]])[0]
            y = _seq_block(par, y, par.cspecs[path][2], c.shape[2])
            c[layer].copy_(y.reshape(c[layer].shape))
    return cache


def _decode_block(par: Par, pattern, blk: Blocks, cblk: dict, cspecs: dict,
                  x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``model._decode_block`` on the rank's blocks; ``cspecs`` are the
    stacked cache leaves' specs (the sequence is their dim 2)."""
    cfg = par.cfg
    for i, (mixer, mlp_kind) in enumerate(pattern):
        sub = blk.sub(f"l{i}/")
        n = len(f"l{i}/")
        csub = {k[n:]: v for k, v in cblk.items() if k.startswith(f"l{i}/")}
        seq = {k[n:]: s[2] for k, s in cspecs.items() if k.startswith(f"l{i}/")}
        if mixer == "attn":
            p = sub.sub("attn/")
            h = L.apply_norm(cfg, p.sub("ln/"), x)
            if cfg.mla:
                h = mla_attention_decode(par, p, h, pos, csub, seq["ckv"])
            else:
                h = attention_decode(par, p, h, pos, csub, seq["k"],
                                     window=cfg.sliding_window)
            x = x + h
            xp = sub.sub("xattn/")
            if "xk" in csub and xp:
                h = L.apply_norm(cfg, xp.sub("ln/"), x)
                x = x + cross_attention_decode(par, xp, h, csub, seq["xk"])
        else:
            p = sub.sub("mamba/")
            x = x + mamba_decode(par, p, L.apply_norm(cfg, p.sub("ln/"), x), csub)
        if mlp_kind == "dense":
            p = sub.sub("mlp/")
            x = x + mlp(par, p, L.apply_norm(cfg, p.sub("ln/"), x))
        elif mlp_kind == "moe":
            p = sub.sub("moe/")
            x = x + moe(par, p, L.apply_norm(cfg, p.sub("ln/"), x))[0]
    return x


def _decode_blocks(par: Par, pattern, P: Blocks, cache: dict, prefix: str,
                   x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    stack = P.sub(prefix)
    n = len(prefix)
    cstack = {k[n:]: v for k, v in cache.items() if k.startswith(prefix)}
    cspecs = {k[n:]: par.cspecs[k] for k in cache if k.startswith(prefix)}
    for layer in range(stack.depth()):
        x = _decode_block(par, pattern, stack.layer(layer),
                          {k: v[layer] for k, v in cstack.items()}, cspecs, x, pos)
    return x


@torch.no_grad()
def decode_step(par: Par, params: Mapping[str, torch.Tensor], cache: dict,
                tokens: torch.Tensor, pos: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """``model.decode_step`` on the rank's blocks: ``tokens`` its rows
    (B_loc, 1), ``pos`` a 0-d tensor on its device, ``cache`` its blocks,
    written in place.  Returns (logits (B_loc, vocab_size), cache): the
    rank's rows of the step's logits, every column."""
    cfg = par.cfg
    P = Blocks(par, params, par.pspecs)
    n_blocks, pattern = cfg.scan_blocks()
    x = embed(par, P["embed"], tokens)
    if cfg.pos_kind == "sinusoidal":
        x = x + L.sinusoidal_embed(pos[None], cfg.d_model)[None].to(x.dtype)
    if cfg.first_dense_layers:
        x = _decode_blocks(par, DENSE, P, cache, "dense_layers/", x, pos)
    x = _decode_blocks(par, pattern, P, cache, "layers/", x, pos)
    x = L.apply_norm(cfg, P.sub("final_norm/"), x)
    return _head(par, P, x)[:, 0, :cfg.vocab_size], cache
