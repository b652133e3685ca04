"""Roofline terms of a step on an NVIDIA H100, from the dry run's counts.

Counterpart of ``repro/launch/roofline.py``.  The reference reads its
terms off a compiled XLA module (``cost_analysis``, the partitioned HLO
text, ``memory_analysis``); the port has no compiler, so ``analyze``
builds the same report from what ``launch/op_costs.py`` counted while one
rank ran the port's own step on ``meta`` tensors (``launch/dryrun.py``).
Every count is a rank's, so:

    compute_s    = flops_per_device / PEAK_FLOPS
    memory_s     = analytic_memory_bytes / HBM_BW     (per device)
    collective_s = collective_bytes_per_device / LINK_BW

The collective bytes are the summed output sizes of the rank's
collectives, as the reference sums the HLO collectives' output shapes (a
ring moves about that much a device); link multiplicity is not modelled.
The memory term uses the reference's analytic estimate of HBM traffic
(``analytic_memory_bytes``), as the reference does whenever it is given.

Hardware model: one NVIDIA H100 SXM ("NVIDIA H100 80GB HBM3", 700 W), the
data sheet's dense rates.  The times are predictions from these
constants, not measurements.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

PEAK_FLOPS = 989e12        # bf16 dense FLOP/s, H100 SXM data sheet
HBM_BW = 3.35e12           # HBM3 bytes/s, H100 SXM data sheet
LINK_BW = 450e9            # NVLink 4 bytes/s a direction (900 GB/s both), data sheet
HBM_BYTES = 80 * 2**30     # the card's device memory ("80GB": 80 GiB usable)


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_breakdown: dict
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float            # 6*N*D (global, per optimizer step)
    useful_flops_ratio: float     # model_flops / (flops_per_device * chips)
    memory_report: str
    bytes_per_device_hbm: Optional[float] = None  # the rank's arguments + outputs + temporaries
    note: str = ""

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["coll_breakdown"] = {k: v for k, v in self.coll_breakdown.items()}
        return d


def analyze(counts: dict, *, arch: str, shape: str, mesh_name: str, chips: int,
            model_flops: float, analytic_mem_bytes: float, note: str = ""
            ) -> RooflineReport:
    """The report of one rank's step from ``counts`` (``op_costs.OpCosts
    .counts()``): its FLOPs, its collectives' bytes by kind and its
    memory (arguments, outputs, temporaries, peak)."""
    flops = float(counts["flops"])
    coll = dict(counts["collective_bytes"])
    coll["total"] = float(sum(counts["collective_bytes"].values()))
    coll["counts"] = dict(counts["collective_calls"])
    mem = counts["memory"]
    compute_s = flops / PEAK_FLOPS
    memory_s = analytic_mem_bytes / HBM_BW
    collective_s = coll["total"] / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    hbm = float(mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"])
    mem_rep = (f"argument {mem['argument_bytes']:,} B, output "
               f"{mem['output_bytes']:,} B, temporaries {mem['temp_bytes']:,} B, "
               f"peak {mem['peak_bytes']:,} B")
    kern = counts.get("kernels") or {}
    if kern:
        note += " kernels=" + ",".join(f"{k}:{v['launches']}x{v['bytes']:.3e}B"
                                       for k, v in sorted(kern.items()))
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_device=flops, bytes_per_device=float(analytic_mem_bytes),
        coll_bytes_per_device=coll["total"], coll_breakdown=coll,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops=model_flops,
        useful_flops_ratio=model_flops / max(flops * chips, 1.0),
        memory_report=mem_rep, bytes_per_device_hbm=hbm, note=note.strip())


def model_flops_for(cfg, shape_info, *, local_steps: int = 1) -> float:
    """6*N*D for training (N = active params, D = global tokens x K),
    2*N*D for inference."""
    from repro_torch.models.model import count_params_analytic
    n_active = count_params_analytic(cfg, active_only=True)
    if shape_info.kind == "train":
        tokens = shape_info.global_batch * shape_info.seq_len * local_steps
        return 6.0 * n_active * tokens
    if shape_info.kind == "prefill":
        tokens = shape_info.global_batch * shape_info.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape_info.global_batch


def format_row(r: RooflineReport) -> str:
    return (f"{r.arch:24s} {r.shape:12s} {r.mesh:10s} "
            f"comp={r.compute_s:9.3e}s mem={r.memory_s:9.3e}s "
            f"coll={r.collective_s:9.3e}s dom={r.dominant:10s} "
            f"useful={r.useful_flops_ratio:6.3f}")


# ---------------------------------------------------------------------------
# The reference's analytic HBM-traffic estimate (its DESIGN §6):
#
#   train:   weights read twice (fwd+bwd) + delta write + moments r/w
#            + activation traffic ~ c_act * tokens * d_model * layers
#   prefill: weights read once + activation traffic
#   decode:  active weights read once per token + KV/SSM cache read
# All divided by the chip count (weights sharded; tokens sharded).
# ---------------------------------------------------------------------------

C_ACT_TRAIN = 16.0   # bytes-touch factor per token-dim-layer (remat incl.)
C_ACT_FWD = 6.0


def analytic_memory_bytes(cfg, shape_info, chips: int, *,
                          moment_bytes: int = 4,
                          local_steps: int = 1) -> float:
    from repro_torch.models.model import count_params_analytic
    n_total = count_params_analytic(cfg)
    n_active = count_params_analytic(cfg, active_only=True)
    wbytes = cfg.dtype.itemsize
    d, L = cfg.d_model, cfg.num_layers

    if shape_info.kind == "train":
        tokens = shape_info.global_batch * shape_info.seq_len * local_steps
        weights = n_total * wbytes * 3.0            # fwd read + bwd read + delta write
        moments = n_total * moment_bytes * 3.0 * 2  # m, v, vhat read+write
        acts = C_ACT_TRAIN * tokens * d * L * wbytes
        return (weights + moments + acts) / chips
    if shape_info.kind == "prefill":
        tokens = shape_info.global_batch * shape_info.seq_len
        return (n_total * wbytes + C_ACT_FWD * tokens * d * L * wbytes) / chips
    # decode: one step
    cache = decode_cache_bytes(cfg, shape_info)
    return (n_active * wbytes + cache) / chips


def decode_cache_bytes(cfg, shape_info) -> float:
    """Total KV/SSM cache bytes read per decode step (global)."""
    B, S = shape_info.global_batch, shape_info.seq_len
    wb = cfg.dtype.itemsize
    total = 0.0
    for mixer, _ in cfg.layer_kinds():
        if mixer == "attn":
            if cfg.mla:
                total += B * S * (cfg.kv_lora_rank + cfg.qk_rope_dim) * wb
            else:
                s_eff = min(S, cfg.sliding_window) if cfg.sliding_window else S
                total += B * s_eff * cfg.num_kv_heads * cfg.hd * 2 * wb
        else:
            total += B * cfg.d_inner * cfg.ssm_state * 4.0
    if cfg.encoder_layers:
        total += cfg.encoder_layers * shape_info.global_batch * \
            cfg.encoder_seq * cfg.num_kv_heads * cfg.hd * 2 * wb
    return total
