"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failed check or exception exits nonzero):

1. card and setup: the card's name and power limit, TF32 off, the
   kernels built from ``src/repro_torch/csrc``;
2. each Hopper kernel against its plain PyTorch version on the card, at
   the test shapes and at the shapes of phases 4 and 5 (with a real
   round's hashes), with its time, the plain version's time, the PyTorch
   library call's time where one exists, and the least time the card could
   take (``bound_ms``); for the count-sketch route also its stages' times,
   its device launches per call, skewed and b >> n cases, and two calls
   held bitwise equal at every main-path shape (phase 11b's vit_base_86m
   and llama3.2-1b uplinks included); for the FWHT every (R, C)
   group of an lm25m SRHT round (sk and desk) and edge shapes, each bit for
   bit, timed with the L2 cache flushed before each call, and the round's
   sum against its bound; then the Gaussian pair (B3 sk, B4 desk) at the
   test shapes, and at full width: every live leaf of the lm25m plan at
   ratio 0.02 through ``kernels.ops.gaussian_sk``/``gaussian_desk``, timed
   at the attention leaf, the largest leaf and over the plan, each beside
   its bound (``GAUSS_TERMS``: per element of R, the least operations on
   each pipe and the least instructions to issue; the earlier one-pipe
   model, which put every integer operation on the 64-lane ALU, beside
   it);
3. two SAFL rounds of bert_100m SMOKE on the card (kernels) against the
   same rounds on the CPU (plain versions), from the same weights, with
   count-sketch, with SRHT and with the Gaussian family; and two SACFL
   (clipped) rounds under partial participation, the cohort masks of the
   two devices bit for bit;
4. the main path: three SAFL rounds of bert_100m at full width and depth,
   independent-hash count-sketch through the count-sketch kernel;
5. three SAFL rounds of the lm25m model with SRHT through the FWHT kernel
   (sk and desk) and the count-sketch kernel (the desk's scatter);
6. the non-i.i.d. path: three SACFL rounds of bert_100m at full width
   under uniform participation (a cohort of 2 of the 5 clients), through
   the count-sketch kernel, with each client's pre-clip delta norm
   against the clip radius on the first round;
7. resume: six SAFL rounds of bert_100m SMOKE on the card under
   participation and a cosine server LR, checkpointed after round 4,
   restored and resumed; bit for bit the uninterrupted run;
8. the paper's comparison baselines: (a) two rounds each of fedavg,
   topk_ef, cocktail, fetchsgd, onebit_adam (warmup 1: both branches) and
   marina (a key whose rounds take both branches) of bert_100m SMOKE on
   the card against the CPU; (b) three FetchSGD rounds of bert_100m at
   full width and depth (the uplink and the re-sketch of the top-k update
   through the count-sketch kernel), then three topk_ef rounds at the
   same width (no kernel), each with the host and device time of its
   top-k;
9. the federated hooks and the streamed fold: (a) two rounds each of the
   streamed fold (microbatch 2 of 5), the fold under scripted faults (a
   NaN and a Byzantine client) with the norm sentinel's two passes (also
   against a second card run, bit for bit), the int8 and 1-bit codecs
   with error feedback and the async buffer (stagger, max_delay 2) of
   bert_100m SMOKE on the card against the CPU, the counters exactly;
   (b) three streamed SAFL rounds of bert_100m at full width under those
   faults, the sentinel and the int8 codec with EF, through the
   count-sketch kernel once per chunk per pass (at G = 2, and G = 1 for
   the tail), with the rejections, the measured bits and a breakdown by
   step; (c) three async rounds at the same width, ``arrival_weight``
   against its closed form, the older generations' operators timed
   apart; (d) the reference's stream workload (a 330-parameter linear
   classifier, microbatch 1,024) at G = 2,048 and 8,192, the round's
   peak memory flat in G;
10. the host runtime: (a) two telemetry rounds each of SAFL, FedOPT,
   SACFL and topk_ef of bert_100m SMOKE under a cohort of 2 of 5 on the
   card against the CPU, every probe within phase 3's tolerance (the
   cohort and clip share exactly, FedOPT's residual exactly 0), and
   ``run_scan`` with and without ``stream=`` bit for bit on the card;
   (b) six telemetry rounds of bert_100m at full width in chunks of 2
   under the rollback supervisor (3 snapshots, a checkpoint every good
   chunk, shards and a manifest), client 1's payload NaN in round 3 of
   the original key: one rollback to round 2, B1 in every round run
   (retried ones too), the run directory valid under the rules of
   ``tools/check_telemetry.py``, the probes' and the snapshots' ms, the
   peak memory, and the run's report with its profile; (c) the
   launchers ``train_lm`` (lm25m, 20 rounds, telemetry, faults, sentinel,
   supervised), ``sketch_size_sweep`` (20 rounds a ratio) and ``heavy_tail``, each's wall
   time.
11. the paper's Fig. 5 and the model zoo: (a) the forward-over-reverse
   HVP of bert_100m SMOKE on the card against the CPU, then the intrinsic
   dimension I = trace|H| / lambda_max of bert_100m at full width and
   depth on one client batch of 16 x 128 tokens (20 Lanczos iterations x
   2 probes, the float64 vectors on the card), with the ms per HVP, the
   whole time and the peak; (b) three SAFL rounds each of vit_base_86m at
   full width and depth and of llama3.2-1b at full width with 2 of its 16
   blocks in bfloat16, through the count-sketch kernel (G = 5), with
   phase 4's checks and breakdown; (c) one client step (loss and
   gradient) of dbrx, falcon-mamba, qwen2-vl, whisper, qwen1.5, qwen2 and
   h2o-danube at full width with one block, in bfloat16 and then in
   float32 on the same weights (losses finite, gradient cosine at least
   0.99; for dbrx the top-k choices and kept-mask entries that differ
   between the two), and every architecture's SMOKE loss and gradients on the card
   against the CPU within phase 3's tolerance (jamba and deepseek-v3
   exceed one card at full width even at one block);
12. cached decode and serving (no TPU kernel on this path; the kernels'
   launch counts are set to 0 before it and printed after): (a)
   llama3.2-1b at full width and all 16 blocks in bfloat16 served through
   ``launch/serve.run``, 8 requests of a 32-token prompt from
   ``synthetic_lm_batch`` and 96 greedy tokens (max_seq 128), twice (the
   same tokens, finite logits, the cache's bytes against ``cache_shapes``),
   with the median ms a step, tokens/s and the peak memory; one step's
   device and host time by layer kind and the device's idle share
   (torch.profiler); then the same weights in float32, every position's
   logits against ``forward`` on the decoded sequence (rtol 2e-2, atol
   2e-3) and the share of bf16 greedy tokens equal to the float32 ones;
   (b) each of 11c's families at full width with one block, 16 decode
   steps at B = 2 in its dtype and in float32 on the same weights, the
   float32 logits against ``forward`` (whisper's ``encode_for_decode``
   over its 1,500 frames first, ``xk`` against ``enc_out @ wk``); (c) all
   twelve SMOKE archs' decode teacher-forced for 24 steps at max_seq 32,
   card against CPU (logits and caches within phase 3's tolerance), and
   ``serve.example()``'s greedy tokens card against CPU;
13. the mesh on ``torch.distributed`` (``launch/mesh.py``, ``launch/
   train.py``): four ranks sharing the card through gloo (NCCL refuses
   two ranks on one device), spawned after the kernels are built; every
   mesh round's client step runs on each rank's own shards
   (``client_deltas_sharded`` over ``models/parallel.py``, no weight
   gathered whole); (a) three SAFL rounds of bert_100m SMOKE in each of
   ``cross_device`` on (data 2, model 2), ``cross_device_dp`` on (2, 2) and
   ``cross_silo`` on (pod 2, data 2, model 1), one FedOPT run and one under
   a cohort of 1 of 2, and one round of deepseek-v3, jamba and whisper
   SMOKE in ``cross_device`` and in ``cross_silo`` on (pod 1, data 2,
   model 2), each against four CPU ranks (running beside the card's)
   within phase 3's tolerance (the families within d/1000 coordinates),
   and ``run_mesh_scan`` bitwise ``run_mesh_host_loop``; (b) three
   bert_100m rounds at full width and depth on (data 2, model 2), G = 2,
   K = 2, 8 x 128 tokens a client, vocabulary cut to 4,096: B1 at G = 1
   over each rank's 66,046,464-coordinate shard in every round on every
   rank, finite losses, uplink bits 2 clients x 2 shards x 1,321,033 x 32,
   round 1's params gathered to rank 0 against a one-process composition
   of the same shard-local sketch on the card (at most d/1000 coordinates
   outside phase 3's tolerance), each round's ms on rank 0, the last
   round timed call by call (the client step and its collective calls,
   ``derive_round_params``, sketch, ``all_reduce``, desk,
   ``apply_update``) and every rank's peak memory; (c) each mesh hook at
   SMOKE size, G = 4, card against CPU; (d) two bert_100m rounds at full
   width, G = 8, under each of the guard (with telemetry and the stream),
   the staleness ring and the streamed fold with the int8 codec; (e) the
   sharded client step alone, one local step of one 512-token client in
   bfloat16 at full width with one block, of dbrx_132b and
   falcon_mamba_7b on (data 1, model 4): every leaf divides, each rank's
   blocks drawn leaf by leaf, each leaf's gradient and delta against the
   one-process step's on the card (cosine >= ``ZOO_MIN_COS``; a delta
   leaf whose step is below its bfloat16 weights' spacing is printed, its
   gradient checked), the ranks' peaks summing under 75 GiB.
14. sharded serving on the mesh (``launch/train.py``'s
   ``make_serve_step``/``make_prefill_step`` with a live mesh,
   ``models/parallel.py``; no TPU kernel on this path: each rank's launch
   counts are set to 0 before it and printed after), the same four ranks
   sharing the card: (a) every SMOKE arch's decode teacher-forced for 8
   steps at B = 4, max_seq 32 in the default, FSDP and flat layouts, the
   logits and the gathered caches against the one-process ``decode_step``
   on the card, and its prefill's blocks (default and FSDP) against
   ``make_prefill_step``, within phase 3's tolerance; (b) llama3.2-1b at
   full width in bfloat16, all 16 blocks in the default layout and 4 in
   the flat layout, each rank's blocks drawn leaf by leaf (the whole
   weights are never on a rank): 8 requests of a 32-token
   ``synthetic_lm_batch`` prompt and 40 greedy tokens (16 under the flat
   layout; the one-process references at the same depth), each rank's weight and cache
   bytes against ``param_shapes``/``cache_shapes``, its peak memory, rank
   0's ms a step (CUDA events) and the share of 8 greedy steps spent
   inside the collectives (gloo), the share of greedy tokens equal to the
   one-process ``serve.run``'s, and 8 float32 teacher-forced steps against
   the one-process float32 decode (12a's tolerance, and within 1e-4).
15. the supervisor over the mesh and the dry run: (a) inside 13a's card
   and CPU ranks, ``run_supervised`` over ``run_mesh_scan`` at bert_100m
   SMOKE on (data 2, model 2), every rank on its own shards, client 1's
   payload NaN in rounds 2 and 3 under the original key: the recovery log
   equal on all eight ranks (one rollback to round 2), the final params
   card against CPU within phase 3's tolerance and d/1000, B1 once a round
   run on every card rank (count set to 0 just before); (b) the dry run
   (``launch/dryrun.py``: rank 0's step on ``meta`` shards under a fake
   process group), run on the host in a process of its own from phase 2
   on (no card visible to it), of 13b's bert_100m round and 13e's
   dbrx_132b client step: its argument bytes exactly the card rank's
   live shards, its peak within ``DRYRUN_PEAK_FACTOR`` of the card's
   ``max_memory_allocated``, B1's meta route once in 13b, and 13e's
   achieved TFLOP/s (its counted FLOPs over the measured step); (c) the
   dry run's per-rank figures and status of jamba-1.5-large's and
   deepseek-v3's client step at one block (deepseek's three dense layers
   kept) on (data 1, model 4), which no card runs.
16. whole heads on a model axis that splits them
   (``models/parallel.py::head_plan``; no TPU kernel on this path, the
   launch counts set to 0 before each part and printed after): (a) inside
   13e's four ranks on (data 1, model 4), SMOKE llama3.2-1b and h2o-danube
   (their 2 key/value heads split) and qwen2-7b and whisper at 6 query
   heads of 32 (the query heads split too), each one's prefill in the
   default and FSDP layouts and one client step (``client_deltas_sharded``)
   against the one-process steps the rank runs on the card, within phase
   3's tolerance (the delta also within ``PART_REL_TOL`` of its largest
   entry); (b) qwen2-7b at full width, one block, on (data 1, model 8),
   eight ranks sharing the card through gloo, where a rank holds 3.5
   query heads and half a key/value head: the float32 prefill of 2 x 512
   tokens against the one-process ``make_prefill_step`` within phase 3's
   tolerance, and 13e's bf16 client step of one 512-token client, each
   leaf's gradient and delta cosine against the one-process step's; rank
   0's ms and collective calls, every rank's peak; (c) the dry run of
   both (from 15b's host process): argument bytes exactly the card rank's
   live shards, the peaks' ratio printed.
17. rematerialization (``models.model.remat_block``, the reference's
   ``jax.checkpoint`` around each block; no TPU kernel on this path, the
   launch counts set to 0 before and printed after): (a) llama3.2-1b at
   its published width and all 16 blocks, bf16, one client's local step
   (``client_delta``, K = 1) of one 4,096-token sequence with each block
   recomputed in the backward: the loss, the step's ms after a warm-up
   and its peak, and the gradient's peak alone; (b) the same step at
   1,024 tokens with and without remat: the loss bit for bit, the delta's
   cosine at least ``REMAT_MIN_COS`` and its largest gap, both peaks and
   the time ratio, timed in turns; (c) the dry run of (a) on ``meta``
   tensors (from 15b's host process, no process group) against the card's
   peaks within ``DRYRUN_PEAK_FACTOR``, and its figures without remat,
   which no phase runs at 4,096 tokens.

Every training loss (phases 3 to 11 and 13 to 17) runs the reference's
default, each block recomputed in the backward (``remat=True``); prefill,
decode and the Fig. 5 HVP (``torch.func``, which refuses a checkpointed
block) run without it.

Phases 4, 5, 6, 8b and 11b end with a breakdown of one round's time by step,
and check each round's uplink bits (per-client payload times the
cohort).

The launch counts of the kernels are set to 0 just before phases 4, 5, 6,
8b, 9b, 10b, 11b (each run) and 13b and the Gaussian full-width run, and read
just after each; the ``kernels`` line has one entry per kernel and path
(the count-sketch's main-path entry, timed at the uplink's shape, counts
phases 4 and 6 and FetchSGD's uplink in 8b; its FetchSGD re-sketch entry,
timed at G = 1, counts the re-sketch's calls in 8b; its streamed-chunk
entry, timed at G = 2, counts 9b's calls; 10b's are added to the main
path's; the entries at vit_base_86m's and llama3.2-1b's uplinks, timed at
G = 5 in phase 2, count their models' rounds in 11b; the mesh uplink's
entry, timed at G = 1 over a rank's shard, counts 13b's calls, set to 0
in each rank just before and summed over the ranks).
The last lines are a
``{"kernels": [...]}`` JSON line, the card's ``nvidia-smi`` line and
``{"ok": true, "device": ...}``.  Needs one CUDA card; exits nonzero
without one.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import prng  # noqa: E402
from repro_torch.checkpoint.io import (restore_checkpoint,  # noqa: E402
                                       save_checkpoint)
from repro_torch.configs import (ARCHS, bert_100m, get_config,  # noqa: E402
                                 llama3_2_1b, vit_base_86m)
from repro_torch.core import baselines as baselines_module  # noqa: E402
from repro_torch.core import clipped as clipped_module  # noqa: E402
from repro_torch.core import safl as safl_module  # noqa: E402
from repro_torch.core import adaptive as adaptive_module  # noqa: E402
from repro_torch.core.adaptive import AdaConfig  # noqa: E402
from repro_torch.core.baselines import (BaselineConfig,  # noqa: E402
                                        baseline_round, init_baseline_state,
                                        uplink_bits)
from repro_torch.core.clipped import (ClippedSAFLConfig,  # noqa: E402
                                      clipped_safl_round)
from repro_torch.core.intrinsic_dim import (intrinsic_dimension,  # noqa: E402
                                            make_hvp)
from repro_torch.core.packed import (derive_round_params,  # noqa: E402
                                     desk_flat, make_packing_plan,
                                     make_sharded_packing_plan,
                                     sk_packed_clients, unpack_tree)
from repro_torch.core.safl import (SAFLConfig, fedopt_round,  # noqa: E402
                                   init_safl, safl_round,
                                   uplink_bits_per_round)
from repro_torch.core.sketch import SketchConfig  # noqa: E402
from repro_torch.data.synthetic import (BigramLMData,  # noqa: E402
                                        ClsDataConfig, GaussianClsData,
                                        LMDataConfig, synthetic_lm_batch)
from repro_torch.fed import (AsyncConfig, CodecConfig,  # noqa: E402
                             FaultTable, SentinelConfig, UniformParticipation,
                             init_async_state, make_async_round)
from repro_torch.fed import async_buffer as async_module  # noqa: E402
from repro_torch.fed import codec as codec_module  # noqa: E402
from repro_torch.fed import faults as faults_module  # noqa: E402
from repro_torch.fed import robust as robust_module  # noqa: E402
from repro_torch.fed.codec import init_codec_state  # noqa: E402
from repro_torch.fed.faults import BYZANTINE, DROP, NAN, OK  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import countsketch as cs  # noqa: E402
from repro_torch.kernels import fwht as fw  # noqa: E402
from repro_torch.kernels import gaussian_sketch as gs  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch import heavy_tail, serve  # noqa: E402
from repro_torch.launch import sketch_size_sweep  # noqa: E402
from repro_torch.launch import supervisor as supervisor_module  # noqa: E402
from repro_torch.launch import train as mesh_train  # noqa: E402
from repro_torch.launch import train_lm  # noqa: E402
from repro_torch.launch.mesh import (Mesh, choose_backend,  # noqa: E402
                                     make_mesh, spawn)
from repro_torch.launch.driver import (COUNTER_KEYS,  # noqa: E402
                                       HISTORY_KEYS, run_scan)
from repro_torch.launch.supervisor import (SupervisorConfig,  # noqa: E402
                                           format_recovery_log,
                                           run_supervised)
from repro_torch.models import layers as layers_module  # noqa: E402
from repro_torch.models import model as model_module  # noqa: E402
from repro_torch.models import parallel  # noqa: E402
from repro_torch.models import sharding  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.sharding import gather_tree, local_shard  # noqa: E402
from repro_torch.models.model import (_cache_dtype, _logits,  # noqa: E402
                                     cache_shapes, decode_step, forward,
                                     init_cache, init_params, loss_fn,
                                     param_shapes)
from repro_torch.obs import REQUIRED_KEYS, ShardWriter, Telemetry  # noqa: E402
from repro_torch.obs import telemetry as telemetry_module  # noqa: E402
from repro_torch.obs import write_manifest  # noqa: E402
from repro_torch.obs.report import load_run, render  # noqa: E402
from repro_torch.optim.schedules import cosine  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
# The least work per element of the Gaussian R that the function needs (the
# reference's _gauss_tile, src/repro/kernels/gaussian_sketch.py:41, plus the
# contraction's multiply-add), as (operations, lanes per SM per clock of the
# pipes that can run them on Hopper).  Integer: 18 = two counters (the
# splitmix32 add folded into a counter stepped by one add, for each of the
# two streams), two mixes of 6 (two xor-shifts and two multiplies), and two
# of the last xor-shift (2).  No >> 8: the last xor can also clear the low 8
# bits, and the result, 256 k for the top 24 bits k, converts to float
# exactly (tests/test_torch_gaussian.py holds this for every k).  The 6 xors
# run only on the integer ALU (LOP3, 64 lanes); the 4 multiplies only on the
# FMA-heavy pipe (IMAD, 64 lanes); a shift or an add on either, so the 18
# share 128 lanes.  float32: 4 (u1's offset and scale, cos's argument,
# r * c, the multiply-add) on the two FMA pipes.  The 16-lane pipe: lg2,
# sqrt and cos; the two uint32 -> float conversions need not use it (I2FP
# does not: with five 16-lane operations an element the attention leaf
# could not take under 18.7 ms, and the kernels take ~17).  Issue: every
# instruction above, 27 with a conversion each, at one warp instruction per
# scheduler per clock (128 lanes an SM).  See PERF.md.
GAUSS_TERMS = {"alu": (6, 64), "imad": (4, 64), "int": (18, 128),
               "fp32": (4, 128), "sfu": (3, 16), "issue": (27, 128)}
# the earlier model, printed beside it: 22 integer operations on one
# 64-lane pipe, 12 float32, 5 on the 16-lane pipe (the conversions included)
GAUSS_TERMS_ONE_PIPE = {"int": (22, 64), "fp32": (12, 128), "sfu": (5, 16)}
G_CLIENTS = 5               # clients per round (the paper's section 5 setup)
CLIP_TAU = 1.0              # SACFL's l2 clip radius of a client's delta
SACFL_TAUS = (CLIP_TAU, 0.5)  # phase 3's radii: the bench's, and one that clips

# examples/train_lm.py's default model, the SRHT phase's model: bert_100m's
# stacked leaves exceed the 16M-element limit of the FWHT kernel path
LM25M = ModelConfig(name="lm25m", arch_type="dense", num_layers=6,
                    d_model=384, num_heads=6, num_kv_heads=6, d_ff=1536,
                    vocab_size=4096)

KERNEL_KEYS = {"name", "route", "source", "replaces", "launches", "max_abs_err",
               "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}

# port vs port across devices: CUDA and CPU float32 matmuls sum in other
# orders (~1e-6 relative), and AMSGrad's normalized step (|step| <= lr *
# 3.2 on round one) amplifies sign-level noise in near-zero sketch slots.
TRAJ_ATOL, TRAJ_RTOL = 2e-3, 1e-3


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup: int = 2, iters: int = 5) -> float:
    """Mean device time of ``fn()`` in ms over ``iters`` runs after warm-up,
    between CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_counts() -> tuple:
    """Every kernel wrapper's launch count."""
    return (cs.LAUNCHES, fw.LAUNCHES, *gs.LAUNCHES.values())


def peak_gib() -> float:
    return torch.cuda.max_memory_allocated() / 2**30


def max_sm_clock_hz() -> float:
    return 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True).stdout.split()[0])


def gauss_bound_terms(n: int, b: int, clock_hz: float, sms: int,
                      terms: dict = GAUSS_TERMS) -> dict[str, float]:
    """The ms of each term of the bound for one Gaussian sk or desk of an
    (n, b) R on a card of ``sms`` SMs: the bytes (x or s read, the output
    written) over the memory rate, and each pipe's operations over its
    lanes at the SM clock."""
    times = {"bytes": (n + b) * 4 / HBM_BYTES_PER_S * 1e3}
    for pipe, (ops, lanes) in terms.items():
        times[pipe] = ops * n * b / (lanes * sms * clock_hz) * 1e3
    return times


def gauss_bound_ms(n: int, b: int, clock_hz: float, sms: int,
                   terms: dict = GAUSS_TERMS) -> tuple[float, str]:
    """The least time for one Gaussian sk or desk: the largest term of
    ``gauss_bound_terms``.  Returns (ms, the term's name)."""
    times = gauss_bound_terms(n, b, clock_hz, sms, terms)
    by = max(times, key=times.get)
    return times[by], by


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def cs_tolerance(x: torch.Tensor, h: torch.Tensor, b: int) -> float:
    """Two float32 summation orders of the same terms differ by at most
    about k * 2**-24 of the slot's absolute sum for k terms; 1e-5 of the
    largest absolute slot sum covers k <= 160.  For more terms of random
    sign (the one-slot cases, k = 100,000) the roundings add as a random
    walk, ~1e-7 of the slot's absolute sum."""
    return 1e-5 * float(cs.countsketch_clients_plain(x.abs(), h, b).max()) + 1e-30


def _errors(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max abs error over max |want|)."""
    if not got.numel():
        return 0.0, 0.0
    err = float((got - want).abs().max())
    return err, err / max(float(want.abs().max()), 1e-30)


def check_countsketch(x: torch.Tensor, h: torch.Tensor, b: int) -> float:
    """The route against its plain version (``index_add_``: the same terms
    in another order) within ``cs_tolerance``, and against the sum in its
    own order (each slot from 0 in ascending i), bit for bit."""
    got = cs.countsketch_clients_cuda(x, h, b)
    want = cs.countsketch_clients_plain(x, h, b)
    torch.cuda.synchronize()
    err, rel = _errors(got, want)
    tol = cs_tolerance(x, h, b)
    exact = torch.equal(got, cs.countsketch_clients_ordered(x, h, b))
    what = f"countsketch G={x.shape[0]} n={x.shape[1]} b={b}"
    print(f"{what}: max_abs_err {err:.3e} max_rel_err {rel:.3e} (tolerance: "
          f"abs {tol:.3e}); bitwise equal to the ordered sum: {exact}")
    check(err <= tol, f"{what}: max abs err {err:.3e} > tol {tol:.3e}")
    check(exact, f"{what}: differs from the sum in ascending index order")
    return err


def check_repeat(x: torch.Tensor, h: torch.Tensor, b: int, what: str) -> None:
    """Two calls on the same inputs return the same bits: the count-sketch
    route sums in a fixed order."""
    same = torch.equal(cs.countsketch_clients_cuda(x, h, b),
                       cs.countsketch_clients_cuda(x, h, b))
    print(f"countsketch {what}: two calls bitwise equal: {same}")
    check(same, f"countsketch {what}: two calls differ")


def cs_stages(x: torch.Tensor, h: torch.Tensor, b: int,
              iters: int = 5) -> str:
    """Device ms of each stage of the count-sketch route (mean over
    ``iters`` calls after a warm-up) and the device launches (kernels and
    memsets) of one call.  The large-n route's stages are timed by CUDA
    events between its launches; the small-n route is one launch, whose
    stages are timed by the card's global timer, read at its grid barriers."""
    cs.countsketch_clients_cuda(x, h, b)
    n0 = cs.DEVICE_LAUNCHES.n
    cs.countsketch_clients_cuda(x, h, b)
    per_call = cs.DEVICE_LAUNCHES.n - n0
    ms: dict[str, float] = {}
    for _ in range(iters):
        marks: list = []
        cs.countsketch_clients_cuda(x, h, b, marks=marks)
        torch.cuda.synchronize()
        events = [m for m in marks if m[0] != "stamps"]
        for (_, a), (stage, e) in zip(events, events[1:]):
            ms[stage] = ms.get(stage, 0.0) + a.elapsed_time(e) / iters
        for stage, t in marks:
            if stage != "stamps":
                continue
            t = t.cpu().tolist()
            ends = {"histogram": [1], "scan": [2],
                    "placement": list(range(3, len(t), 2)),
                    "reduce": list(range(4, len(t), 2))}
            for name, ks in ends.items():
                ms[name] = ms.get(name, 0.0) + sum(t[k] - t[k - 1] for k in ks) / 1e6 / iters
    return (", ".join(f"{k} {v:.4f}" for k, v in ms.items())
            + f"; {per_call} device launches per call")


def check_fwht(x: torch.Tensor) -> float:
    """B2 against its plain version: the same additions in the same order,
    so bit for bit (max_abs_err 0), and within rel 1e-6 as before."""
    got = fw.fwht_rows_cuda(x)
    want = fw.fwht_plain(x)
    torch.cuda.synchronize()
    err, rel = _errors(got, want)
    tol = 1e-6
    exact = torch.equal(got, want)
    print(f"fwht {tuple(x.shape)}: max_abs_err {err:.3e} max_rel_err "
          f"{rel:.3e} (tolerance: rel {tol:.0e}); bitwise equal: {exact}")
    check(rel <= tol, f"fwht {tuple(x.shape)}: max rel err {rel:.3e} > {tol:.0e}")
    check(exact and err == 0, f"fwht {tuple(x.shape)}: differs from the plain version")
    return err


def cold_ms(fn, flush: torch.Tensor, iters: int = 5) -> float:
    """Mean device ms of fn() by CUDA events around each call alone, with
    the L2 cache flushed (flush.zero_(), over its 50 MB) before each."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def fwht_bound(x: torch.Tensor) -> tuple[float, str]:
    """Each element read once and written once; log2(C) additions each."""
    return bound_ms(2 * x.numel() * 4, x.numel() * math.log2(x.shape[1]))


def time_fwht(x: torch.Tensor, flush: torch.Tensor, what: str) -> tuple[float, float]:
    """B2's and the plain version's cold-L2 ms on x, printed with the bound
    and the launches of one call; returns (ms, plain_ms)."""
    n0, d0 = fw.LAUNCHES.n, fw.DEVICE_LAUNCHES.n
    fw.fwht_rows_cuda(x)
    calls, device = fw.LAUNCHES.n - n0, fw.DEVICE_LAUNCHES.n - d0
    ms = cold_ms(lambda: fw.fwht_rows_cuda(x), flush)
    plain_ms = cold_ms(lambda: fw.fwht_plain(x), flush, 2)
    bms, by = fwht_bound(x)
    print(f"fwht {what} {tuple(x.shape)}: ms {ms:.4f}; plain_ms {plain_ms:.4f}; "
          f"bound_ms {bms:.4f} ({by}); {calls} kernel launch, {device} device "
          f"launches (kernels and memsets) per call; L2 flushed before each "
          f"timed call")
    return ms, plain_ms


# B2 beyond the round's groups: a row of 2, one short of and one past a
# row tile, a long row of 2 * 4096, the longest row (4096^2), 33 rows of
# 4096, and the reference's test shapes
FWHT_EDGE_SHAPES = ((1, 2), (3, 2048), (7, 8192), (1, 1 << 24), (33, 4096),
                    (1, 8), (9, 4096), (20, 512), (1, 32768))


# B1 cases beyond the reference's test shapes: (G, n, b, hash), where the
# hash "zero" puts all of n into slot 0; the last takes the large-n route
CS_EDGE_CASES = ((1, 100_000, 1, "zero"), (1, 100_000, 300, "zero"),
                 (1, 17, 1 << 22, "random"), (1, 70_779, 1 << 22, "random"),
                 (13, 5000, 300, "random"), (3, 0, 64, "random"),
                 (7, cs.COARSE_MIN_N + 12_345, 30_000, "random"))


def uplink_entry(name: str, what: str, x: torch.Tensor, h: torch.Tensor,
                 b: int) -> dict:
    """B1 at a round's uplink shape: checked against its plain version and
    the ordered sum, twice bitwise equal, timed beside the plain version
    and ``index_add_``; its ``kernels`` entry, launches still 0."""
    g, n = x.shape
    err = check_countsketch(x, h, b)
    check_repeat(x, h, b, what)
    ms = cuda_ms(lambda: cs.countsketch_clients_cuda(x, h, b))
    stages = cs_stages(x, h, b)
    plain_ms = cuda_ms(lambda: cs.countsketch_clients_plain(x, h, b))
    zeros = torch.zeros((g, b), device=x.device)
    lib_ms = cuda_ms(lambda: zeros.index_add_(1, h, x))
    bms, by = bound_ms(x.numel() * 4 + h.numel() * h.element_size() + g * b * 4,
                       x.numel())
    width = cs.route(n, b)[0]
    print(f"countsketch {what} G={g} n={n} b={b} (window {width}, "
          f"{-(-b // width)} windows of at most {cs.MAX_WINDOWS}): stages (ms) "
          f"{stages}")
    print(f"countsketch {what} G={g} n={n} b={b}: ms {ms:.3f} (the whole route); "
          f"plain_ms {plain_ms:.3f}; library_ms (index_add_) {lib_ms:.3f}; "
          f"bound_ms {bms:.3f} ({by})")
    return dict(name=name, route="cuda", source="src/repro_torch/csrc/countsketch.cu",
                replaces="src/repro/kernels/countsketch.py:45", launches=0,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms)


def phase_kernels(gen: torch.Generator) -> list[dict]:
    dev = "cuda"
    print("== phase 2: kernels against their plain versions ==")
    for g, n, b, kind in ([(1, n, b, "random") for n in (17, 1000, 1024, 5000)
                           for b in (8, 128, 300)]
                          + [(1, 3000, 2049, "random"), (1, 3000, 4096, "random"),
                             (1, 100, 16, "random"), (5, 2000, 64, "random"),
                             (9, 1500, 3000, "random")]
                          + list(CS_EDGE_CASES)):
        x = torch.randn((g, n), generator=gen, device=dev)
        h = (torch.zeros(n, dtype=torch.int64, device=dev) if kind == "zero"
             else torch.randint(0, b, (n,), generator=gen, device=dev))
        check_countsketch(x, h, b)

    # B1 at phase 11b's uplinks (vit_base_86m, and llama3.2-1b's two blocks:
    # the most windows of any path), G = 5 with a real round's hash; each
    # its own entry, its launches those of its model's rounds
    g = G_CLIENTS
    entries = []
    for name, model in ZOO_ROUNDS:
        plan = make_packing_plan(MAIN_SKETCH, param_shape_tree(model))
        h = derive_round_params(plan, prng.fold_in(prng.key(0), 0), dev)["h"]
        x = torch.randn((g, plan.d_total), generator=gen, device=dev) * 1e-3
        entries.append(uplink_entry(f"countsketch_{name}", f"{name} uplink", x, h,
                                    plan.b_total))
        del x, h
        torch.cuda.empty_cache()

    # B1 at the main path's shape, with a real round's hash
    plan = make_packing_plan(MAIN_SKETCH, param_shape_tree(bert_100m.CONFIG))
    rp = derive_round_params(plan, prng.fold_in(prng.key(0), 0), dev)
    h, b = rp["h"], plan.b_total
    x = torch.randn((g, plan.d_total), generator=gen, device=dev) * 1e-3
    entries.insert(0, uplink_entry("countsketch_clients", "main path", x, h, b))

    # B1 at FetchSGD's re-sketch of its top-k update (phase 8): G = 1 over
    # all of d_total, the same plan and hash as the uplink; its entry's
    # max_abs_err is against the ordered sum
    x1 = x[:1].contiguous()
    check_countsketch(x1, h, b)
    err = _errors(cs.countsketch_clients_cuda(x1, h, b),
                  cs.countsketch_clients_ordered(x1, h, b))[0]
    print(f"countsketch FetchSGD re-sketch: max_abs_err {err:.3e} against the "
          f"ordered sum (the entry's)")
    check_repeat(x1, h, b, "FetchSGD re-sketch")
    ms = cuda_ms(lambda: cs.countsketch_clients_cuda(x1, h, b))
    plain_ms = cuda_ms(lambda: cs.countsketch_clients_plain(x1, h, b))
    zeros = torch.zeros((1, b), device=dev)
    lib_ms = cuda_ms(lambda: zeros.index_add_(1, h, x1))
    bms, by = bound_ms(x1.numel() * 4 + h.numel() * h.element_size() + b * 4,
                       x1.numel())
    print(f"countsketch FetchSGD re-sketch G=1 n={plan.d_total} b={b} (window "
          f"{cs.route(plan.d_total, b)[0]}): stages (ms) {cs_stages(x1, h, b)}")
    print(f"countsketch FetchSGD re-sketch G=1 n={plan.d_total} b={b}: ms {ms:.3f}; "
          f"plain_ms {plain_ms:.3f}; library_ms (index_add_) {lib_ms:.3f}; "
          f"bound_ms {bms:.4f} ({by})")
    entries.append(dict(name="countsketch_resketch", route="cuda",
                        source="src/repro_torch/csrc/countsketch.cu",
                        replaces="src/repro/kernels/countsketch.py:45",
                        launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bms, bound_by=by, library_ms=lib_ms))
    # B1 at the streamed fold's chunk (phase 9b): G = 2 of the same uplink
    x2 = x[:STREAM_MB].contiguous()
    err = check_countsketch(x2, h, b)
    check_repeat(x2, h, b, "streamed chunk")
    ms = cuda_ms(lambda: cs.countsketch_clients_cuda(x2, h, b))
    plain_ms = cuda_ms(lambda: cs.countsketch_clients_plain(x2, h, b))
    zeros = torch.zeros((STREAM_MB, b), device=dev)
    lib_ms = cuda_ms(lambda: zeros.index_add_(1, h, x2))
    bms, by = bound_ms(x2.numel() * 4 + h.numel() * h.element_size()
                       + STREAM_MB * b * 4, x2.numel())
    print(f"countsketch streamed chunk G={STREAM_MB} n={plan.d_total} b={b}: "
          f"stages (ms) {cs_stages(x2, h, b)}")
    print(f"countsketch streamed chunk G={STREAM_MB} n={plan.d_total} b={b}: "
          f"ms {ms:.3f}; plain_ms {plain_ms:.3f}; library_ms (index_add_) "
          f"{lib_ms:.3f}; bound_ms {bms:.3f} ({by})")
    entries.append(dict(name="countsketch_chunk", route="cuda",
                        source="src/repro_torch/csrc/countsketch.cu",
                        replaces="src/repro/kernels/countsketch.py:45",
                        launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bms, bound_by=by, library_ms=lib_ms))
    del h, rp, zeros, x1, x2
    torch.cuda.empty_cache()

    # the same uplink at the smaller ratios users also run (more indices
    # per slot: ~100 and ~200); checked and timed, not on the main path
    for ratio in (0.01, 0.005):
        sk = dataclasses.replace(MAIN_SKETCH, ratio=ratio)
        plan = make_packing_plan(sk, param_shape_tree(bert_100m.CONFIG))
        h = derive_round_params(plan, prng.fold_in(prng.key(0), 0), dev)["h"]
        b = plan.b_total
        check_countsketch(x, h, b)
        check_repeat(x, h, b, f"bert_100m uplink at ratio {ratio}")
        ms = cuda_ms(lambda: cs.countsketch_clients_cuda(x, h, b))
        zeros = torch.zeros((g, b), device=dev)
        lib_ms = cuda_ms(lambda: zeros.index_add_(1, h, x))
        bms, by = bound_ms(x.numel() * 4 + h.numel() * h.element_size() + g * b * 4,
                           x.numel())
        print(f"countsketch bert_100m uplink at ratio {ratio} G={g} "
              f"n={plan.d_total} b={b} (window {cs.route(plan.d_total, b)[0]}): "
              f"stages (ms) {cs_stages(x, h, b)}")
        print(f"countsketch bert_100m uplink at ratio {ratio}: ms {ms:.3f}; "
              f"library_ms (index_add_) {lib_ms:.3f}; bound_ms {bms:.3f} ({by})")
        del h, zeros
    del x
    torch.cuda.empty_cache()

    # B1 at the mesh uplink (phase 13b): each rank of the (data 2, model 2)
    # grid sketches its client's model shard, G = 1 over the shard-local
    # plan, with a real round's hash
    plan = mesh_plan(bert_100m.CONFIG)
    h = derive_round_params(plan, prng.fold_in(prng.key(0), 0), dev)["h"]
    x = torch.randn((1, plan.d_total), generator=gen, device=dev) * 1e-3
    entries.append(uplink_entry("countsketch_mesh", "mesh uplink", x, h,
                                plan.b_total))
    del x
    torch.cuda.empty_cache()
    # the same shard at G = 4: a rank's four clients in 13d's guarded and
    # buffered rounds
    x = torch.randn((MESH_FULL_CLIENTS // 2, plan.d_total), generator=gen,
                    device=dev) * 1e-3
    entries.append(uplink_entry("countsketch_mesh_g4", "mesh uplink, 4 clients a rank",
                                x, h, plan.b_total))
    del x, h
    torch.cuda.empty_cache()

    # the SRHT phase (the lm25m plan) with a real round's operator: B1 as
    # the desk scatter of each live op's b payload slots into n2 slots, B2
    # on each padded-length group's rows, (G * L, n2) in sk, (L, n2) in desk
    plan = make_packing_plan(SRHT_SKETCH, param_shape_tree(LM25M))
    rp = derive_round_params(plan, prng.fold_in(prng.key(0), 0), dev)
    live = [op for op in plan.ops if not op.raw]
    err = max(check_countsketch(torch.randn((1, op.b), generator=gen, device=dev),
                                rp["srht"][op.index][1], op.n2) for op in live)
    op = max(live, key=lambda o: (o.n2, o.b))
    x = torch.randn((1, op.b), generator=gen, device=dev)
    idx = rp["srht"][op.index][1]
    ms = cuda_ms(lambda: cs.countsketch_clients_cuda(x, idx, op.n2))
    plain_ms = cuda_ms(lambda: cs.countsketch_clients_plain(x, idx, op.n2))
    zeros = torch.zeros(op.n2, device=dev)
    lib_ms = cuda_ms(lambda: zeros.index_add_(0, idx, x[0]))
    bms, by = bound_ms(x.numel() * 4 + idx.numel() * idx.element_size()
                       + op.n2 * 4, x.numel())
    check_repeat(x, idx, op.n2, "SRHT desk scatter")
    print(f"countsketch SRHT desk scatter G=1 n={op.b} b={op.n2} (window "
          f"{cs.route(op.b, op.n2)[0]}): stages (ms) "
          f"{cs_stages(x, idx, op.n2)}")
    print(f"countsketch SRHT desk scatter G=1 n={op.b} b={op.n2}: ms {ms:.4f}; "
          f"plain_ms {plain_ms:.4f}; library_ms (index_add_) {lib_ms:.4f}; "
          f"bound_ms {bms:.4f} ({by})")
    entries.append(dict(name="countsketch", route="cuda",
                        source="src/repro_torch/csrc/countsketch.cu",
                        replaces="src/repro/kernels/countsketch.py:45",
                        launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bms, bound_by=by, library_ms=lib_ms))
    del rp, x, zeros

    # B2 at every (R, n2) group of the round, sk (G * L rows) and desk (L),
    # then the edge shapes; each bit for bit, timed with a cold L2
    groups: dict[int, int] = {}
    for op in live:
        groups[op.n2] = groups.get(op.n2, 0) + 1
    flush = torch.empty(64 << 20, device=dev)     # 256 MB, over the L2
    err, ms_sum, bound_sum = 0.0, 0.0, 0.0
    for n2, rows in sorted(groups.items()):     # the last, largest, is the entry's
        for r, what in ((G_CLIENTS * rows, "SRHT sk group"), (rows, "SRHT desk group")):
            x = torch.randn((r, n2), generator=gen, device=dev)
            err = max(err, check_fwht(x))
            ms, plain_ms = time_fwht(x, flush, what)
            ms_sum += ms
            bound_sum += fwht_bound(x)[0]
            if r == G_CLIENTS * rows:
                big = (x.shape, ms, plain_ms)
            del x
    print(f"fwht one lm25m SRHT round ({2 * len(groups)} calls): ms {ms_sum:.4f} "
          f"(sum of the cold-L2 times above); bound_ms {bound_sum:.4f}")
    for shape in FWHT_EDGE_SHAPES:
        x = torch.randn(shape, generator=gen, device=dev)
        err = max(err, check_fwht(x))
        same = torch.equal(fw.fwht_rows_cuda(x), fw.fwht_rows_cuda(x))
        check(same, f"fwht {shape}: two calls differ")
        if shape[1] > fw.MAX_C:
            time_fwht(x, flush, "edge")
    shape, ms, plain_ms = big
    x = torch.randn(shape, generator=gen, device=dev)
    same = torch.equal(fw.fwht_rows_cuda(x), fw.fwht_rows_cuda(x))
    warm = cuda_ms(lambda: fw.fwht_rows_cuda(x))
    print(f"fwht SRHT sk group {tuple(shape)}: two calls bitwise equal: {same}; "
          f"ms {warm:.4f} back to back (warm), {ms:.4f} cold")
    check(same, f"fwht {tuple(shape)}: two calls differ")
    bms, by = fwht_bound(x)
    entries.append(dict(name="fwht_rows", route="cuda",
                        source="src/repro_torch/csrc/fwht.cu",
                        replaces="src/repro/kernels/fwht.py:26", launches=0,
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bms, bound_by=by, library_ms=None))
    del x, flush
    return entries


# the Gaussian pair is held at the lm25m plan at the SRHT phase's ratio
GAUSS_SKETCH = SketchConfig(kind="gaussian", ratio=0.02, min_b=64)
# float32 sums of up to ~10^6 products in two orders (the kernels: long
# sequential runs per thread or lane; the plain versions: matmuls per tile
# group), plus an ulp or two of log/cos per element: a random walk of
# ~1e-6 of the largest output.  Adjointness: two float32 dot products of
# the same terms.
GAUSS_REL_TOL = 1e-4


def check_gauss(kind: str, got: torch.Tensor, want: torch.Tensor,
                shape: tuple) -> float:
    torch.cuda.synchronize()
    err, rel = _errors(got, want)
    print(f"gaussian_{kind} (n, b)={shape}: max_abs_err {err:.3e} "
          f"max_rel_err {rel:.3e} (tolerance: rel {GAUSS_REL_TOL:.0e})")
    check(bool(torch.isfinite(got).all()) and got.shape == want.shape,
          f"gaussian_{kind} {shape}: not finite or shape {tuple(got.shape)}")
    check(rel <= GAUSS_REL_TOL, f"gaussian_{kind} {shape}: max rel err "
          f"{rel:.3e} > {GAUSS_REL_TOL:.0e}")
    return err


def check_adjoint(v, s, sk_v, desk_s, what: str) -> None:
    """<sk(v), s> == <v, desk(s)>, to GAUSS_REL_TOL of |sk(v)| |s|."""
    lhs, rhs = float(sk_v @ s), float(v @ desk_s)
    scale = float(sk_v.norm() * s.norm())
    print(f"gaussian adjointness {what}: <sk(v), s> {lhs:.6e} <v, desk(s)> "
          f"{rhs:.6e}")
    check(abs(lhs - rhs) <= GAUSS_REL_TOL * scale,
          f"gaussian adjointness {what}: {lhs} != {rhs}")


def phase_gaussian(gen: torch.Generator) -> list[dict]:
    """B3 and B4 against their plain versions at the reference's test
    shapes; then the slice's path at full width, every live leaf of the
    lm25m plan through ``kernels.ops`` (the launch counts set to 0 just
    before and read just after); then checks and times at its shapes."""
    dev = "cuda"
    print("== phase 2: the Gaussian pair (B3 sk, B4 desk) ==")
    err = {"sk": 0.0, "desk": 0.0}
    for n, b in ((100, 16), (513, 64), (2000, 128), (1500, 128), (900, 64)):
        x = torch.randn(n, generator=gen, device=dev)
        s = torch.randn(b, generator=gen, device=dev)
        sk, desk = gs.gaussian_sk_cuda(11, x, b), gs.gaussian_desk_cuda(11, s, n)
        err["sk"] = max(err["sk"], check_gauss("sk", sk,
                                               gs.gaussian_sk_plain(11, x, b), (n, b)))
        err["desk"] = max(err["desk"], check_gauss(
            "desk", desk, gs.gaussian_desk_plain(11, s, n), (n, b)))
        check_adjoint(x, s, sk, desk, f"{(n, b)}")

    plan = make_packing_plan(GAUSS_SKETCH, param_shape_tree(LM25M))
    live = [op for op in plan.ops if not op.raw]
    key = prng.fold_in(prng.key(0), 0)
    seeds = {op.index: prng.fold_in(key, op.tag)[1] for op in live}
    deltas = {op.index: torch.randn(op.n, generator=gen, device=dev) * 1e-3
              for op in live}
    total = sum(op.n * op.b for op in live)
    print(f"lm25m Gaussian plan: {len(live)} live leaves, sum n*b {total:.4g}, "
          f"shapes {[(op.n, op.b) for op in live]}")

    # the path: each leaf's delta through B3, its payload through B4
    for c in gs.LAUNCHES.values():
        c.n = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pays, backs = {}, {}
    for op in live:
        pays[op.index] = kops.gaussian_sk(seeds[op.index], deltas[op.index], op.b)
        backs[op.index] = kops.gaussian_desk(seeds[op.index], pays[op.index], op.n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.n for k, c in gs.LAUNCHES.items()}
    print(f"lm25m Gaussian path (sk + desk of every live leaf): {wall:.3f} s, "
          f"launches {launches}")
    for op in live:
        v, p, back = deltas[op.index], pays[op.index], backs[op.index]
        check(p.shape == (op.b,) and back.shape == (op.n,)
              and bool(torch.isfinite(p).all()) and bool(torch.isfinite(back).all()),
              f"gaussian path leaf {op.index}: shapes or values wrong")
        check_adjoint(v, p, p, back, f"leaf {op.index} {(op.n, op.b)}")

    # full check at the attention-leaf shape; the first 8 tiles at the
    # largest b, where the counter stride 2b is largest
    att = next(op for op in live if op.n == 884_736)
    big = max(live, key=lambda o: (o.b, o.n))
    i, seed = att.index, seeds[att.index]
    err["sk"] = max(err["sk"], check_gauss(
        "sk", pays[i], gs.gaussian_sk_plain(seed, deltas[i], att.b),
        (att.n, att.b)))
    err["desk"] = max(err["desk"], check_gauss(
        "desk", backs[i], gs.gaussian_desk_plain(seed, pays[i], att.n),
        (att.n, att.b)))
    j, seed, m = big.index, seeds[big.index], 8 * gs.TILE_N
    head = deltas[j][:m].contiguous()
    err["sk"] = max(err["sk"], check_gauss(
        "sk", gs.gaussian_sk_cuda(seed, head, big.b),
        gs.gaussian_sk_plain(seed, head, big.b), (m, big.b)))
    err["desk"] = max(err["desk"], check_gauss(
        "desk", backs[j][:m], gs.gaussian_desk_plain(seed, pays[j], m),
        (m, big.b)))

    # times: kernel and plain at the attention-leaf shape, the kernel alone
    # at the largest leaf and over the whole plan
    clock = max_sm_clock_hz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    x, p = deltas[i], pays[i]
    seed = seeds[i]
    ms = {"sk": cuda_ms(lambda: gs.gaussian_sk_cuda(seed, x, att.b), 1, 3),
          "desk": cuda_ms(lambda: gs.gaussian_desk_cuda(seed, p, att.n), 1, 3)}
    plain = {"sk": cuda_ms(lambda: gs.gaussian_sk_plain(seed, x, att.b), 0, 1),
             "desk": cuda_ms(lambda: gs.gaussian_desk_plain(seed, p, att.n), 0, 1)}
    bms, by = gauss_bound_ms(att.n, att.b, clock, sms)
    x, p, seed = deltas[j], pays[j], seeds[j]
    big_ms = {"sk": cuda_ms(lambda: gs.gaussian_sk_cuda(seed, x, big.b), 0, 2),
              "desk": cuda_ms(lambda: gs.gaussian_desk_cuda(seed, p, big.n), 0, 2)}
    big_bms, big_by = gauss_bound_ms(big.n, big.b, clock, sms)
    plan_ms = {
        "sk": cuda_ms(lambda: [gs.gaussian_sk_cuda(seeds[o.index], deltas[o.index], o.b)
                               for o in live], 0, 1),
        "desk": cuda_ms(lambda: [gs.gaussian_desk_cuda(seeds[o.index], pays[o.index], o.n)
                                 for o in live], 0, 1)}
    plan_bms = sum(gauss_bound_ms(o.n, o.b, clock, sms)[0] for o in live)
    old = {"att": gauss_bound_ms(att.n, att.b, clock, sms, GAUSS_TERMS_ONE_PIPE)[0],
           "big": gauss_bound_ms(big.n, big.b, clock, sms, GAUSS_TERMS_ONE_PIPE)[0],
           "plan": sum(gauss_bound_ms(o.n, o.b, clock, sms, GAUSS_TERMS_ONE_PIPE)[0]
                       for o in live)}
    print(f"max SM clock {clock / 1e6:.0f} MHz; {sms} SMs; per element of R "
          f"(operations, lanes an SM): {GAUSS_TERMS}; one-pipe model: {GAUSS_TERMS_ONE_PIPE}")
    terms = gauss_bound_terms(att.n, att.b, clock, sms)
    print("gaussian bound terms, attention leaf (ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in terms.items()))
    for k in ("sk", "desk"):
        print(f"gaussian_{k} attention leaf (n, b)=({att.n}, {att.b}): ms "
              f"{ms[k]:.3f}; plain_ms {plain[k]:.3f}; bound_ms {bms:.3f} ({by}; "
              f"one-pipe model {old['att']:.3f}); largest leaf ({big.n}, {big.b}): ms "
              f"{big_ms[k]:.3f}, bound_ms {big_bms:.3f} ({big_by}; one-pipe model "
              f"{old['big']:.3f}); whole plan ({len(live)} leaves): ms "
              f"{plan_ms[k]:.3f}, bound_ms {plan_bms:.3f} (one-pipe model {old['plan']:.3f})")
    bound_by = "bytes" if by == "bytes" else "operations"
    return [dict(name=f"gaussian_{k}", route="cuda",
                 source="src/repro_torch/csrc/gaussian_sketch.cu",
                 replaces=f"src/repro/kernels/gaussian_sketch.py:{line}",
                 launches=launches[f"gaussian_{k}"], max_abs_err=err[k],
                 ms=ms[k], plain_ms=plain[k], bound_ms=bms, bound_by=bound_by,
                 library_ms=None)
            for k, line in (("sk", 55), ("desk", 67))]


# ---------------------------------------------------------------------------
# SAFL phases
# ---------------------------------------------------------------------------

MAIN_SKETCH = SketchConfig(kind="countsketch", ratio=0.02, min_b=64,
                           cs_hash="independent", use_kernels=True)
SRHT_SKETCH = SketchConfig(kind="srht", ratio=0.02, min_b=64, use_kernels=True)


@dataclasses.dataclass(frozen=True)
class _Shape:
    shape: tuple
    dtype: torch.dtype = torch.float32


def param_shape_tree(model: ModelConfig) -> dict:
    return {k: _Shape(s) for k, s in param_shapes(model).items()}


def safl_cfg(sketch: SketchConfig, server: str = "amsgrad") -> SAFLConfig:
    return SAFLConfig(sketch=sketch, server=AdaConfig(name=server, lr=0.01),
                      client_lr=0.5, local_steps=2)


def per_client_bits(model: ModelConfig, sketch: SketchConfig,
                    baseline: BaselineConfig | None = None) -> int:
    if baseline is not None:
        return uplink_bits(baseline, param_shape_tree(model))
    return uplink_bits_per_round(safl_cfg(sketch), param_shape_tree(model))


def run_rounds(model: ModelConfig, sketch: SketchConfig, data: LMDataConfig,
               device: str, rounds: int, per_round=None, server="amsgrad",
               clip_tau=None, policy=None, baseline=None, seed: int = 0,
               microbatch=None, faults=None, sentinel=None, codec=None,
               acfg=None, fedopt=False, telemetry=None, stream=None):
    """``rounds`` rounds through ``run_scan`` under ``prng.key(seed)``, one
    round a chunk: SAFL, SACFL with ``clip_tau``, FedOPT with ``fedopt``,
    the async buffer of ``acfg`` or the ``baseline`` (whose own config then
    holds the sketch and server); every client in every round, or the
    cohorts of ``policy``; with the streamed fold's ``microbatch``, the
    ``faults`` policy, the ``sentinel``, the ``codec`` (with error
    feedback, its memory in the state), the ``telemetry`` probes and the
    driver's ``stream``.  ``uplink_bits`` bills the clients that
    transmit."""
    cfg = safl_cfg(sketch, server)
    params = init_params(model, torch.Generator().manual_seed(0), device=device)
    sampler = BigramLMData(data).device_sampler(batch_per_client=8,
                                                local_steps=2)
    loss = lambda p, b: loss_fn(model, p, b)
    if baseline is not None:
        plan = make_packing_plan(baseline.sketch, params)
        state = init_baseline_state(baseline, params, data.num_clients, plan=plan)
        round_fn = functools.partial(baseline_round, baseline, loss, plan=plan,
                                     telemetry=telemetry)
    elif acfg is not None:
        plan = make_packing_plan(cfg.sketch, params)
        state = init_async_state(cfg, acfg, params, plan, data.num_clients,
                                 codec=codec)
        round_fn = make_async_round(cfg, loss, acfg, plan, microbatch=microbatch,
                                    codec=codec)
        microbatch = codec = None           # bound into the async round
    else:
        plan = make_packing_plan(cfg.sketch, params)
        state = init_safl(cfg, params)
        ef = init_codec_state(codec, data.num_clients, plan.b_total, device)
        if ef is not None:
            state = {"opt": state, "ef": ef}
        if fedopt:
            round_fn = functools.partial(fedopt_round, cfg, loss,
                                         telemetry=telemetry)
        elif clip_tau is None:
            round_fn = functools.partial(safl_round, cfg, loss, plan=plan,
                                         sentinel=sentinel, telemetry=telemetry)
        else:
            round_fn = functools.partial(
                clipped_safl_round, ClippedSAFLConfig(base=cfg, clip_tau=clip_tau),
                loss, plan=plan, sentinel=sentinel, telemetry=telemetry)
    # under a policy the driver multiplies the per-client bits by the cohort
    bits = per_client_bits(model, sketch, baseline) * (
        1 if policy else data.num_clients)
    return run_scan(round_fn, sampler, params, state, rounds=rounds,
                    key=prng.key(seed), chunk_size=1, bits_per_round=bits,
                    on_chunk=per_round, participation=policy,
                    buffer=acfg is not None, faults=faults,
                    microbatch=microbatch, codec=codec, stream=stream)


class ClipNorms:
    """Within ``with``: each client's pre-clip delta norm (``clip_delta``'s
    global norm) and ``clip_trigger`` for the first ``count`` clients that
    SACFL clips, that is the first round's."""

    def __init__(self, count: int = G_CLIENTS):
        self.count, self.seen = count, []

    def __enter__(self):
        self.clip_delta = clipped_module.clip_delta

        def recording(cfg, delta):
            if len(self.seen) < self.count:
                nrm = torch.sqrt(sum(torch.sum(x.to(torch.float32) ** 2)
                                     for x in delta.values()) + 1e-12)
                self.seen.append((float(nrm),
                                  float(clipped_module.clip_trigger(cfg, delta))))
            return self.clip_delta(cfg, delta)

        clipped_module.clip_delta = recording
        return self

    def __exit__(self, *exc):
        clipped_module.clip_delta = self.clip_delta

    def report(self, what: str, tau: float) -> None:
        print(f"{what} round 0: pre-clip delta norm against tau " + ", ".join(
            f"client {c} {nrm:.4f} {'>' if trig else '<='} {tau}"
            for c, (nrm, trig) in enumerate(self.seen)))
        check(len(self.seen) == self.count,
              f"{what}: {len(self.seen)} clipped clients in round 0")
        for nrm, trig in self.seen:
            check(math.isfinite(nrm) and trig == float(nrm > tau),
                  f"{what}: clip_trigger {trig} disagrees with the norm {nrm}")


class RecordedPolicy:
    """A participation policy that keeps every mask it hands the driver."""

    def __init__(self, policy):
        self.policy, self.masks = policy, []

    def mask(self, t: int, device):
        m = self.policy.mask(t, device)
        self.masks.append(m)
        return m


# (sketch, ratio, server optimizer) of each SMOKE run.  The Gaussian
# family (``use_kernels`` routes nothing different for it, as in the
# reference) draws ~3e7 normals per sk or desk at ratio 0.002, which keeps
# the CPU's threefry in PyTorch integer ops to seconds.  Its server is
# plain SGD: each coordinate's desketched update is a sum over all b slots,
# so some lie near zero, and AMSGrad's normalized step turns the ulp-level
# gap between the two devices' draws into sign flips there
# (tests/test_torch_gaussian.py measures this against the reference).
SMOKE_RUNS = ((MAIN_SKETCH, 0.05, "amsgrad"), (SRHT_SKETCH, 0.05, "amsgrad"),
              (dataclasses.replace(GAUSS_SKETCH, use_kernels=True), 0.002, "sgd"))


def compare_card_cpu(what: str, card, cpu, allowed: int = 0) -> None:
    """Losses and parameters of one run on the card against the CPU's; at
    most ``allowed`` coordinates may lie outside the tolerance."""
    (pg, _, hg), (pc, _, hc) = card, cpu
    print(f"{what}: loss card {hg['loss']} cpu {hc['loss']}")
    check(np.allclose(hg["loss"], hc["loss"], rtol=1e-4, atol=1e-4),
          f"SMOKE {what} losses differ between card and CPU")
    worst, outside = 0.0, 0
    for k in pc:
        a, b = pg[k].cpu(), pc[k]
        check(bool(torch.isfinite(a).all()), f"SMOKE {what}: param {k} not finite")
        worst = max(worst, float((a - b).abs().max()))
        outside += int((~torch.isclose(a, b, rtol=TRAJ_RTOL, atol=TRAJ_ATOL)).sum())
    print(f"{what}: params max abs diff card vs cpu {worst:.3e} "
          f"(tolerance atol {TRAJ_ATOL}, rtol {TRAJ_RTOL}); coordinates "
          f"outside it {outside} (allowed {allowed})")
    check(outside <= allowed,
          f"SMOKE {what}: {outside} params differ between card and CPU")


def smoke_data() -> LMDataConfig:
    return LMDataConfig(vocab_size=256, seq_len=32, num_clients=G_CLIENTS,
                        heterogeneity=0.3, alpha=0.02)


def phase_card_vs_cpu() -> None:
    print("== phase 3: bert_100m SMOKE, card (kernels) against CPU (plain) ==")
    data = smoke_data()
    for sketch, ratio, server in SMOKE_RUNS:
        sk = dataclasses.replace(sketch, ratio=ratio, min_b=16)
        t0 = time.perf_counter()
        card = run_rounds(bert_100m.SMOKE, sk, data, "cuda", 2, server=server)
        t1 = time.perf_counter()
        cpu = run_rounds(bert_100m.SMOKE, sk, data, "cpu", 2, server=server)
        print(f"{sk.kind} (ratio {ratio}, server {server}): card {t1 - t0:.1f} s, "
              f"cpu {time.perf_counter() - t1:.1f} s")
        compare_card_cpu(sk.kind, card, cpu)

    # SACFL under partial participation: the cohorts the driver handed the
    # rounds on each device, bit for bit.  These SMOKE clients' deltas stay
    # inside the bench's radius 1.0, so a second pair clips at 0.5
    sk = dataclasses.replace(MAIN_SKETCH, ratio=0.05, min_b=16)
    for tau in SACFL_TAUS:
        what = f"sacfl (tau {tau}, cohort 2 of {G_CLIENTS})"
        pols = {d: RecordedPolicy(UniformParticipation(G_CLIENTS, frac=0.4, seed=123))
                for d in ("cuda", "cpu")}
        with ClipNorms() as norms:
            card = run_rounds(bert_100m.SMOKE, sk, data, "cuda", 2, clip_tau=tau,
                              policy=pols["cuda"])
        cpu = run_rounds(bert_100m.SMOKE, sk, data, "cpu", 2, clip_tau=tau,
                         policy=pols["cpu"])
        masks = {d: [m.cpu() for m in p.masks] for d, p in pols.items()}
        print(f"{what}: masks card {[m.tolist() for m in masks['cuda']]}; "
              f"uplink_bits {card[2]['uplink_bits']}")
        norms.report(what, tau)
        check(len(masks["cuda"]) == len(masks["cpu"]) == 2
              and all(torch.equal(a, b) for a, b in zip(masks["cuda"], masks["cpu"])),
              f"SMOKE {what}: cohort masks differ between card and CPU")
        check(all(float(m.sum()) == 2.0 for m in masks["cuda"]),
              f"SMOKE {what}: a cohort is not 2 clients")
        compare_card_cpu(what, card, cpu)
    check(any(trig for _, trig in norms.seen),
          f"SMOKE sacfl: no client clipped at tau {SACFL_TAUS[-1]}")


def full_data(vocab: int = 4096) -> LMDataConfig:
    """The full-width phases' bigram data: 4,096 tokens, or a smaller
    model's whole vocabulary."""
    return LMDataConfig(vocab_size=vocab, seq_len=128, num_clients=G_CLIENTS,
                        heterogeneity=0.3, alpha=0.02)


def phase_full(name: str, model: ModelConfig, sketch: SketchConfig,
               counters: dict[str, build.LaunchCount],
               **round_kw) -> tuple[dict[str, int], float]:
    """Three rounds through ``run_scan`` (``round_kw``: SACFL's clip radius,
    a participation policy or a baseline, as ``run_rounds`` takes them);
    every count in ``counters`` is set to 0 just before and must grow in
    every round, and each round's uplink bits must be the per-client
    payload times the cohort.  Then one round's time by step.  Returns the
    counts after the run and its peak device memory in GiB."""
    data = full_data(min(model.vocab_size, 4096))
    policy = round_kw.get("policy")
    cohort = policy.cohort_size if policy else G_CLIENTS
    want_bits = float(np.float32(
        per_client_bits(model, sketch, round_kw.get("baseline")) * cohort))
    torch.cuda.reset_peak_memory_stats()
    marks = []

    def per_round(t, params, state, hist):
        torch.cuda.synchronize()
        marks.append((t, time.perf_counter(),
                      {k: c.n for k, c in counters.items()},
                      float(hist["loss"][-1]), float(hist["uplink_bits"][-1])))

    for c in counters.values():
        c.n = 0
    t0 = time.perf_counter()
    params, _, hist = run_rounds(model, sketch, data, "cuda", 3, per_round,
                                 **round_kw)
    torch.cuda.synchronize()
    launches = {k: c.n for k, c in counters.items()}
    d = sum(p.numel() for p in params.values())
    print(f"{name}: d = {d:,} parameters, launches in the run: {launches}")
    prev_t, prev_n, steady = None, {k: 0 for k in counters}, []
    for t, tw, n, loss, bits in marks:
        ms = ""
        if prev_t is not None:
            steady.append((tw - prev_t) * 1e3)
            ms = f"  round ms {steady[-1]:.1f}"
        print(f"{name} round {t - 1}: loss {loss:.5f}  uplink_bits {bits:.0f}  "
              f"kernel launches {n}{ms}")
        check(math.isfinite(loss), f"{name}: loss is not finite")
        check(bits == want_bits, f"{name}: uplink_bits {bits} in round {t - 1}, "
              f"not the per-client payload times {cohort} ({want_bits})")
        for k in counters:
            check(n[k] >= prev_n[k] + 1, f"{name}: {k} launch count did not "
                  f"grow in round {t - 1}")
        prev_t, prev_n = tw, n
    stats = torch.cuda.memory_stats()
    peak = peak_gib()
    print(f"{name}: first round (with set-up) "
          f"{(marks[0][1] - t0) * 1e3:.1f} ms; steady round ms "
          f"{', '.join(f'{x:.1f}' for x in steady)}; uplink_bits a round "
          f"{want_bits:.0f} (cohort {cohort}); peak device memory "
          f"{peak:.2f} GiB; allocator "
          f"cudaMalloc calls {stats.get('num_device_alloc')}, retries after "
          f"freeing its cache {stats.get('num_alloc_retries')} (since the start)")
    for k, v in params.items():
        check(bool(torch.isfinite(v).all()), f"{name}: param {k} not finite")
    del params
    round_breakdown(name, model, sketch, data, **round_kw)
    return launches, peak


# the calls a round makes, timed one by one in ``round_breakdown``: those of
# ``safl_round``, and for SACFL's round also the clip
ROUND_STEPS = tuple((safl_module, s) for s in (
    "client_delta", "derive_round_params", "sk_packed_clients", "desk_packed",
    "apply_update"))
CLIPPED_STEPS = ROUND_STEPS + ((clipped_module, "clip_delta"),)
# FetchSGD's: the clients, the operator, the uplink sketch (B1), the cohort
# mean into the sketch momentum and error, the desketch, the per-op top-k,
# the re-sketch of the update (B1 at G = 1) and the server step
FETCHSGD_STEPS = ROUND_STEPS[:1] + tuple((baselines_module, s) for s in (
    "derive_round_params", "sk_packed_clients", "_sketch_momentum",
    "desk_flat", "_heavy_hitters", "sk_flat", "apply_update"))
# topk_ef's: the clients, packing the error-fed deltas into (G, d_total),
# the top-k of each row and the server step
TOPK_EF_STEPS = ROUND_STEPS[:1] + tuple((baselines_module, s) for s in (
    "pack_rows", "topk_mask", "apply_update"))


def round_breakdown(name: str, model: ModelConfig, sketch: SketchConfig,
                    data: LMDataConfig, steps=None, labels=None,
                    **round_kw) -> None:
    """Where one round's time goes: two more rounds through ``run_scan``,
    with each call of the real round to a step in ``steps`` (by default
    ``ROUND_STEPS``; SACFL: ``CLIPPED_STEPS``; FetchSGD and topk_ef:
    ``FETCHSGD_STEPS`` and ``TOPK_EF_STEPS``) timed on the host clock, the
    device synchronised around it; ``labels[step](i)`` names the step's
    i-th call of a round where it differs.  The second round is printed,
    with the caching allocator's calls to ``cudaMalloc`` in each step;
    ``rest`` is what the steps leave of it (sampling, stacking the deltas,
    the cohort mean, the driver)."""
    times: dict[str, float] = {}
    mallocs: dict[str, int] = {}
    calls: dict[str, int] = {}
    rounds: list[tuple[float, dict, dict]] = []

    def device_allocs() -> int:
        return torch.cuda.memory_stats().get("num_device_alloc", 0)

    def timed(step, fn):
        def call(*args, **kwargs):
            label = step
            if labels and step in labels:
                label = labels[step](calls.get(step, 0))
            calls[step] = calls.get(step, 0) + 1
            torch.cuda.synchronize()
            n0, t0 = device_allocs(), time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times[label] = times.get(label, 0.0) + (time.perf_counter() - t0) * 1e3
            mallocs[label] = mallocs.get(label, 0) + device_allocs() - n0
            return out
        return call

    def per_round(t, params, state, hist):
        torch.cuda.synchronize()
        rounds.append((time.perf_counter(), dict(times), dict(mallocs)))
        times.clear()
        mallocs.clear()
        calls.clear()

    if steps is not None:
        pass
    elif round_kw.get("baseline") is not None:
        steps = {"fetchsgd": FETCHSGD_STEPS,
                 "topk_ef": TOPK_EF_STEPS}[round_kw["baseline"].name]
    elif round_kw.get("clip_tau") is not None:
        steps = CLIPPED_STEPS
    else:
        steps = ROUND_STEPS
    saved = [(mod, s, getattr(mod, s)) for mod, s in steps]
    for mod, s, fn in saved:
        setattr(mod, s, timed(s, fn))
    try:
        run_rounds(model, sketch, data, "cuda", 2, per_round, **round_kw)
    finally:
        for mod, s, fn in saved:
            setattr(mod, s, fn)
    total = (rounds[1][0] - rounds[0][0]) * 1e3
    parts, allocs = dict(rounds[1][1]), rounds[1][2]
    parts["rest"] = total - sum(parts.values())
    print(f"{name} round breakdown (ms, round {total:.1f}; cudaMalloc calls): "
          + ", ".join(f"{k} {v:.1f} ({100 * v / total:.0f}%; {allocs.get(k, '-')})"
                      for k, v in parts.items()))


def phase_noniid() -> dict[str, int]:
    """Phase 6: SACFL at full width under uniform participation, with each
    client's pre-clip delta norm (``clip_delta``'s global norm) against the
    clip radius on the first round."""
    print("== phase 6: non-i.i.d. SACFL, bert_100m full width ==")
    policy = UniformParticipation(G_CLIENTS, frac=0.4, seed=123)
    check(policy.cohort_size == 2, f"cohort {policy.cohort_size}, not 2")
    with ClipNorms() as norms:
        n, _ = phase_full("bert_100m sacfl", bert_100m.CONFIG, MAIN_SKETCH,
                          {"countsketch": cs.LAUNCHES,
                           "countsketch_device": cs.DEVICE_LAUNCHES},
                          clip_tau=CLIP_TAU, policy=policy)
    print(f"bert_100m sacfl round 0: cohort {policy.mask(0, 'cpu').tolist()}")
    norms.report("bert_100m sacfl", CLIP_TAU)
    return n


def phase_resume() -> None:
    """Phase 7: a run stopped after round 4, checkpointed, restored and
    resumed at ``start_round=4`` equals the uninterrupted run bit for bit."""
    print("== phase 7: resume, bert_100m SMOKE on the card ==")
    model, rounds, stop = bert_100m.SMOKE, 6, 4
    cfg = safl_cfg(dataclasses.replace(MAIN_SKETCH, ratio=0.05, min_b=16))
    sampler = BigramLMData(smoke_data()).device_sampler(batch_per_client=8,
                                                        local_steps=2)

    def fresh():
        params = init_params(model, torch.Generator().manual_seed(0), "cuda")
        return params, init_safl(cfg, params)

    def cursor_state(params, opt, t, key):
        return {"params": params, "opt": opt,
                "cursor": {"t": torch.tensor(t),
                           "key": torch.tensor(key, dtype=torch.uint32)}}

    sched = cosine(rounds)
    run = functools.partial(
        run_scan, functools.partial(safl_round, cfg, lambda p, b: loss_fn(model, p, b),
                                    plan=make_packing_plan(cfg.sketch, fresh()[0])),
        sampler, chunk_size=2, bits_per_round=per_client_bits(model, cfg.sketch),
        participation=UniformParticipation(G_CLIENTS, frac=0.4, seed=123),
        kwargs_fn=lambda t: {"lr_scale": sched(t)})
    key = prng.key(0)
    t0 = time.perf_counter()
    p_ref, s_ref, h_ref = run(*fresh(), rounds=rounds, key=key)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ckpt")

        def on_chunk(t_done, params, opt, hist):
            if t_done == stop:
                save_checkpoint(path, cursor_state(params, opt, t_done, key),
                                step=t_done)

        _, _, h_a = run(*fresh(), rounds=stop, key=key, on_chunk=on_chunk)
        state, step = restore_checkpoint(path, cursor_state(*fresh(), 0, (0, 0)))
    k2 = tuple(int(k) for k in state["cursor"]["key"].tolist())
    check(step == stop and int(state["cursor"]["t"]) == stop and k2 == key,
          f"restored cursor {step}, {state['cursor']}")
    p_b, s_b, h_b = run(state["params"], state["opt"], rounds=rounds, key=k2,
                        start_round=stop)
    stitched = {k: np.concatenate([h_a[k], h_b[k]]) for k in h_ref}
    print(f"resume: loss {h_ref['loss']}, resumed {h_b['loss']}; uplink_bits "
          f"{h_ref['uplink_bits']}; lr_scale {[sched(t) for t in range(rounds)]}; "
          f"{time.perf_counter() - t0:.1f} s")
    for k in h_ref:
        check(np.array_equal(stitched[k], h_ref[k]),
              f"resume: stitched {k} history differs from the uninterrupted run's")
    for k in p_ref:
        check(torch.equal(p_b[k], p_ref[k]), f"resume: param {k} differs")
    for name in ("m", "v", "vhat"):
        for k in s_ref[name]:
            check(torch.equal(s_b[name][k], s_ref[name][k]),
                  f"resume: opt state {name}/{k} differs")
    check(torch.equal(s_b["step"], s_ref["step"]), "resume: opt step differs")
    print("resume: params, opt state and the stitched history bitwise equal "
          "to the uninterrupted run's")


# ---------------------------------------------------------------------------
# phase 8: the paper's comparison baselines
# ---------------------------------------------------------------------------

# each baseline's server as the bench runs it (benchmarks/run.py:147)
BASELINE_SERVERS = {"fedavg": AdaConfig(name="sgd", lr=1.0),
                    "topk_ef": AdaConfig(name="sgd", lr=1.0),
                    "fetchsgd": AdaConfig(name="sgd", lr=1.0),
                    "onebit_adam": AdaConfig(name="adam", lr=0.01),
                    "marina": AdaConfig(name="sgd", lr=0.5),
                    "cocktail": AdaConfig(name="sgd", lr=1.0)}


def baseline_cfg(name: str, sketch: SketchConfig, **kw) -> BaselineConfig:
    """A baseline as the bench runs it: its server, client lr 0.5, K = 2,
    the top-k ratio equal to the sketch's ratio."""
    return BaselineConfig(name=name, client_lr=0.5, local_steps=2,
                          server=BASELINE_SERVERS[name], topk_ratio=sketch.ratio,
                          sketch=sketch, **kw)


def marina_branches(seed: int, p: float, rounds: int) -> list[bool]:
    """Whether each round of a run under ``prng.key(seed)`` is a MARINA full
    sync: the round's own ``bernoulli(fold_in(key, t), p)``, on the host."""
    return [bool(prng.bernoulli(prng.fold_in(prng.key(seed), t), p, (), "cpu"))
            for t in range(rounds)]


def phase_baselines_smoke() -> None:
    """Phase 8a: two rounds of each baseline on the card (kernels) and on
    the CPU (plain versions), from the same weights.

    The parameters are held at the tolerance of phase 3, with a counted
    number of coordinates allowed outside it.  Top-k (topk_ef, fetchsgd): a
    coordinate at a client's (or an op's) threshold can be kept on one
    device and not the other, which moves that coordinate alone; up to one
    in a thousand of the k kept may.  1-bit Adam (warmup 1, so the warm and
    the compressed branch both run): the sign of a near-zero error-fed
    coordinate is float noise, and the frozen variance of one warm round is
    tiny (sqrt(v) ~3e-6 at the median), so ``m / sqrt(v)`` turns a flipped
    sign into a large move; on the CPU, the port against the reference
    from the same weights, 79 of 329,728 coordinates left the tolerance (up
    to 0.35, with |p| up to 267), and up to one in a thousand of d may."""
    print("== phase 8a: baselines, bert_100m SMOKE, card (kernels) against "
          "CPU (plain) ==")
    data = smoke_data()
    sk = dataclasses.replace(MAIN_SKETCH, ratio=0.05, min_b=16)
    d = sum(math.prod(s) for s in param_shapes(bert_100m.SMOKE).values())
    k = int(d * sk.ratio)
    seed = next(s for s in range(1000)
                if marina_branches(s, BaselineConfig().marina_p, 2) == [True, False])
    runs = (("fedavg", {}, 0), ("topk_ef", {}, k // 1000),
            ("cocktail", {}, 0), ("fetchsgd", {}, k // 1000),
            ("onebit_adam", {"onebit_warmup": 1}, d // 1000), ("marina", {}, 0))
    for name, kw, allowed in runs:
        cfg = baseline_cfg(name, sk, **kw)
        s = seed if name == "marina" else 0
        t0 = time.perf_counter()
        card = run_rounds(bert_100m.SMOKE, sk, data, "cuda", 2, baseline=cfg, seed=s)
        t1 = time.perf_counter()
        cpu = run_rounds(bert_100m.SMOKE, sk, data, "cpu", 2, baseline=cfg, seed=s)
        want = float(np.float32(per_client_bits(bert_100m.SMOKE, sk, cfg) * G_CLIENTS))
        print(f"{name}: card {t1 - t0:.1f} s, cpu {time.perf_counter() - t1:.1f} s; "
              f"uplink_bits {card[2]['uplink_bits']} (want {want:.0f} a round)")
        check(all(b == want for b in card[2]["uplink_bits"]),
              f"SMOKE {name}: uplink bits {card[2]['uplink_bits']}")
        if name == "marina":
            print(f"marina (key seed {seed}): round 0 full sync, round 1 "
                  f"compressed difference")
        compare_card_cpu(f"{name} (k = {k}, d = {d})" if allowed else name,
                         card, cpu, allowed=allowed)


def profile_device(what: str, fn) -> None:
    """The host clock around one call of ``fn`` (after a warm-up), against
    the device time and the count of the kernels it launches, and the three
    kernels that take most of that time (torch.profiler)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = []
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
        if t > 0:
            kernels.append((t / 1e3, e.count, e.key.split("(")[0][:60]))
    dev_ms = sum(t for t, _, _ in kernels)
    top = sorted(kernels, reverse=True)[:3]
    print(f"{what}: host {host_ms:.1f} ms a call, device busy {dev_ms:.1f} ms in "
          f"{sum(c for _, c, _ in kernels)} kernels ({100 * dev_ms / host_ms:.0f}% "
          f"of the host's time; profiler); most device time: "
          + "; ".join(f"{name} {t:.1f} ms in {c}" for t, c, name in top))


def phase_baselines_full() -> dict[str, int]:
    """Phase 8b: FetchSGD at bert_100m full width (B1 twice a round: the
    uplink, G = 5, and the re-sketch of the top-k update, G = 1), then
    topk_ef at the same width, which runs no kernel."""
    print("== phase 8b: FetchSGD, bert_100m full width ==")
    cfg = baseline_cfg("fetchsgd", MAIN_SKETCH, fetchsgd_momentum=0.9)
    # the route's own count, split by the rows of the call: G_CLIENTS for the
    # uplink, 1 for the re-sketch
    by_rows = {G_CLIENTS: build.LaunchCount(), 1: build.LaunchCount()}
    route = cs.countsketch_clients_cuda

    def counted(x, h, b, **kw):
        n0 = cs.LAUNCHES.n
        out = route(x, h, b, **kw)
        by_rows[x.shape[0]].n += cs.LAUNCHES.n - n0
        return out

    cs.countsketch_clients_cuda = counted
    try:
        n, _ = phase_full("bert_100m fetchsgd", bert_100m.CONFIG, MAIN_SKETCH,
                          {"countsketch": cs.LAUNCHES,
                           "countsketch_device": cs.DEVICE_LAUNCHES,
                           "countsketch_uplink": by_rows[G_CLIENTS],
                           "countsketch_resketch": by_rows[1]}, baseline=cfg)
    finally:
        cs.countsketch_clients_cuda = route
    for what in ("uplink", "resketch"):
        check(n[f"countsketch_{what}"] == 3, f"fetchsgd: "
              f"{n[f'countsketch_{what}']} B1 {what} calls in 3 rounds, not 1 a round")
    check(n["countsketch"] == 2 * 3, f"fetchsgd: {n['countsketch']} B1 calls "
          f"in 3 rounds, not 2 a round (uplink and re-sketch)")
    plan = make_packing_plan(MAIN_SKETCH, param_shape_tree(bert_100m.CONFIG))
    dense = torch.randn(plan.d_total, device="cuda") * 1e-3
    profile_device(f"fetchsgd per-op top-k ({len(plan.ops)} ops)",
                   lambda: baselines_module._heavy_hitters(cfg, plan, dense))
    del dense
    torch.cuda.empty_cache()
    print("== phase 8b: topk_ef, bert_100m full width (no kernel) ==")
    cfg = baseline_cfg("topk_ef", MAIN_SKETCH)
    phase_full("bert_100m topk_ef", bert_100m.CONFIG, MAIN_SKETCH, {}, baseline=cfg)
    a2 = torch.randn((G_CLIENTS, plan.d_total), device="cuda") * 1e-3
    k = int(plan.d_total * cfg.topk_ratio)
    profile_device(f"topk_ef top-k of ({G_CLIENTS}, {plan.d_total})",
                   lambda: baselines_module.topk_mask(a2, k))
    return n


# ---------------------------------------------------------------------------
# phase 9: the federated hooks and the streamed fold
# ---------------------------------------------------------------------------

STREAM_MB = 2               # clients per chunk of the streamed fold
# one NaN client and one Byzantine (x1e3) client every round
HOOK_FAULTS = FaultTable(((OK, NAN, OK, BYZANTINE, OK),), cyclic=True)
HOOK_REJECTED = 2           # both caught: the NaN by the finite check, the
                            # Byzantine by the norm sentinel
HOOK_SENTINEL = SentinelConfig(norm_mult=10.0)
HOOK_ASYNC = AsyncConfig(max_delay=2, delay="stagger")


def compare_counters(what: str, card, cpu) -> None:
    """The guard's and the buffer's counters and the billed bits of two
    runs, exactly."""
    hg, hc = card[2], cpu[2]
    check(set(hg) == set(hc), f"{what}: history keys {sorted(hg)} / {sorted(hc)}")
    for k in COUNTER_KEYS + ("uplink_bits",):
        if k in hg:
            check(np.array_equal(hg[k], hc[k]),
                  f"{what}: {k} card {hg[k]} cpu {hc[k]}")
    print(f"{what}: counters card " + ", ".join(
        f"{k} {hg[k].tolist()}" for k in COUNTER_KEYS + ("uplink_bits",) if k in hg)
          + " (equal on the CPU)")


def phase_hooks_smoke() -> None:
    """Phase 9a: two rounds of each hook at SMOKE size on the card against
    the CPU, with phase 3's model, data and tolerance, and the counters of
    the two devices exactly equal; the two-pass round also against a
    second card run of itself, bit for bit.

    The codecs round stochastically: a payload coordinate whose rounding
    point lies within the two devices' float noise of a level boundary
    decodes one level apart (int8: max|row| / 127), which moves its slot's
    cohort mean and, through AMSGrad's normalized step, the coordinates
    hashed into that slot.  Up to one in a thousand of d may leave the
    tolerance in a codec run (10 of 329,728, up to 5.4e-3, in two int8
    rounds with EF on an NVIDIA H100 80GB HBM3 at 700 W)."""
    print("== phase 9a: federated hooks, bert_100m SMOKE, card against CPU ==")
    data = smoke_data()
    sk = dataclasses.replace(MAIN_SKETCH, ratio=0.05, min_b=16)
    d = sum(math.prod(s) for s in param_shapes(bert_100m.SMOKE).values())
    runs = (("streamed (microbatch 2 of 5)", dict(microbatch=STREAM_MB)),
            ("streamed, faults + norm sentinel (two passes)",
             dict(microbatch=STREAM_MB, faults=HOOK_FAULTS, sentinel=HOOK_SENTINEL)),
            ("streamed, int8 codec with EF",
             dict(microbatch=STREAM_MB, codec=CodecConfig(bits=8))),
            ("1-bit codec with EF", dict(codec=CodecConfig(bits=1))),
            ("async, stagger, max_delay 2 (microbatch 2)",
             dict(microbatch=STREAM_MB, acfg=HOOK_ASYNC)))
    for what, kw in runs:
        t0 = time.perf_counter()
        card = run_rounds(bert_100m.SMOKE, sk, data, "cuda", 2, **kw)
        t1 = time.perf_counter()
        cpu = run_rounds(bert_100m.SMOKE, sk, data, "cpu", 2, **kw)
        print(f"{what}: card {t1 - t0:.1f} s, cpu {time.perf_counter() - t1:.1f} s")
        compare_counters(what, card, cpu)
        compare_card_cpu(what, card, cpu,
                         allowed=d // 1000 if "codec" in kw else 0)
        if "sentinel" in kw:
            check(list(card[2]["n_rejected"]) == [HOOK_REJECTED] * 2,
                  f"{what}: n_rejected {card[2]['n_rejected']}")
            again = run_rounds(bert_100m.SMOKE, sk, data, "cuda", 2, **kw)
            same = (all(np.array_equal(card[2][k], again[2][k]) for k in card[2])
                    and all(torch.equal(card[0][k], again[0][k]) for k in card[0]))
            print(f"{what}: a second card run bitwise equal: {same}")
            check(same, f"{what}: two card runs differ")


def run_counted(name: str, rounds: int, counters: dict, peak4: float,
                **round_kw):
    """``rounds`` rounds of bert_100m at full width through ``run_rounds``,
    every count in ``counters`` set to 0 just before and read just after;
    prints each round's loss, counters and host ms, and the peak device
    memory beside phase 4's of this run (``peak4``).  Returns (history,
    launches, the steady rounds' ms, peak GiB)."""
    torch.cuda.reset_peak_memory_stats()
    marks = []

    def per_round(t, params, state, hist):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), {k: c.n for k, c in counters.items()}))

    for c in counters.values():
        c.n = 0
    t0 = time.perf_counter()
    params, _, hist = run_rounds(bert_100m.CONFIG, MAIN_SKETCH, full_data(), "cuda",
                                 rounds, per_round, **round_kw)
    torch.cuda.synchronize()
    launches = {k: c.n for k, c in counters.items()}
    steady = [(b[0] - a[0]) * 1e3 for a, b in zip(marks, marks[1:])]
    for t in range(rounds):
        print(f"{name} round {t}: " + ", ".join(
            f"{k} {hist[k][t]:.6g}" for k in hist) + f"; launches {marks[t][1]}"
              + (f"; round ms {steady[t - 1]:.1f}" if t else
                 f"; first round (with set-up) {(marks[0][0] - t0) * 1e3:.1f} ms"))
    for k, v in params.items():
        check(bool(torch.isfinite(v).all()), f"{name}: param {k} not finite")
    check(all(math.isfinite(x) for x in hist["loss"]), f"{name}: loss not finite")
    peak = peak_gib()
    print(f"{name}: launches in the run {launches}; steady round ms "
          f"{', '.join(f'{x:.1f}' for x in steady)}; peak device memory "
          f"{peak:.2f} GiB (phase 4's materialized round in this run: {peak4:.2f} GiB)")
    return hist, launches, steady, peak


def phase_streamed_full(peak4: float) -> int:
    """Phase 9b: three streamed SAFL rounds of bert_100m at full width
    (microbatch 2 of 5: chunks of 2, 2 and a masked 1) under the faults of
    ``HOOK_FAULTS``, the norm sentinel (two passes) and the int8 codec with
    error feedback, through B1 once per chunk per pass.  Returns B1's
    launches."""
    print("== phase 9b: streamed SAFL + faults + sentinel + int8 codec, "
          "bert_100m full width ==")
    codec = CodecConfig(bits=8, error_feedback=True)
    b_total = make_packing_plan(MAIN_SKETCH, param_shape_tree(bert_100m.CONFIG)).b_total
    check(b_total == 2_640_275, f"b_total {b_total}")
    survivors = G_CLIENTS - HOOK_REJECTED
    want_bits = float(np.float32((8 * b_total + 32) * survivors))
    n_chunks = -(-G_CLIENTS // STREAM_MB)
    kw = dict(microbatch=STREAM_MB, faults=HOOK_FAULTS, sentinel=HOOK_SENTINEL,
              codec=codec)
    hist, launches, _, _ = run_counted(
        "bert_100m streamed", 3, {"countsketch": cs.LAUNCHES,
                                  "countsketch_device": cs.DEVICE_LAUNCHES},
        peak4, **kw)
    check(list(hist["n_rejected"]) == [HOOK_REJECTED] * 3,
          f"streamed: n_rejected {hist['n_rejected']}, scripted {HOOK_REJECTED} a round")
    check(list(hist["n_dropped"]) == [0.0] * 3 and list(hist["diverged"]) == [0.0] * 3,
          f"streamed: n_dropped {hist['n_dropped']}, diverged {hist['diverged']}")
    check(all(b == want_bits for b in hist["uplink_bits"]),
          f"streamed: uplink_bits {hist['uplink_bits']}, not (8 * {b_total} + 32) "
          f"x {survivors} = {want_bits:.0f}")
    want_calls = 2 * n_chunks * 3
    check(launches["countsketch"] == want_calls,
          f"streamed: {launches['countsketch']} B1 calls, not 2 passes x "
          f"{n_chunks} chunks x 3 rounds = {want_calls}")
    print(f"bert_100m streamed: uplink_bits {want_bits:.0f} a round = (8 x {b_total} "
          f"+ 32) x {survivors} survivors; B1 {launches['countsketch']} calls = 2 passes "
          f"x {n_chunks} chunks x 3 rounds")
    steps = tuple((safl_module, s) for s in (
        "client_deltas", "derive_round_params", "sk_packed_clients", "desk_packed",
        "apply_update")) + ((codec_module, "encode_decode"),
                            (faults_module, "corrupt_payload"),
                            (robust_module, "masked_median"))
    labels = {"client_deltas": lambda i: f"clients pass {1 + i // n_chunks}",
              "sk_packed_clients": lambda i: "sketch",
              "encode_decode": lambda i: "codec",
              "corrupt_payload": lambda i: "guard",
              "masked_median": lambda i: "guard",
              "desk_packed": lambda i: "desk"}
    round_breakdown("bert_100m streamed", bert_100m.CONFIG, MAIN_SKETCH, full_data(),
                    steps=steps, labels=labels, **kw)
    return launches["countsketch"]


def async_arrival_closed_form(acfg: AsyncConfig, t: int, g: int) -> float:
    """Round t's total arrival weight under the stagger policy with every
    client sampled: client c of generation t - d arrives when
    ``(c + t - d) % D == d``, at weight ``(1 + d) ** -alpha`` in float32,
    summed by delay in the round's order."""
    D = acfg.buffer_rounds
    total = None
    for d in range(D):
        if t - d < 0 and d > 0:
            n = 0
        else:
            n = sum(1 for c in range(g) if (c + t - d) % D == d)
        w = np.float32(n) * np.float32((1.0 + d) ** -acfg.staleness_alpha)
        total = w if total is None else np.float32(total + w)
    return float(total)


def phase_async_full(peak4: float) -> None:
    """Phase 9c: three async rounds of bert_100m at full width (stagger,
    max_delay 2: every generation's clients have popped within three
    rounds), staged through microbatch 2; ``arrival_weight`` against its
    closed form, and the older generations' operators timed apart."""
    print("== phase 9c: async staleness buffer, bert_100m full width ==")
    gen_ms: list = []
    derive = async_module.derive_generation_params

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = derive(*args, **kwargs)
        torch.cuda.synchronize()
        gen_ms.append((args[2], (time.perf_counter() - t0) * 1e3))
        return out

    async_module.derive_generation_params = timed
    try:
        hist, launches, steady, _ = run_counted(
            "bert_100m async", 3, {"countsketch": cs.LAUNCHES}, peak4,
            microbatch=STREAM_MB, acfg=HOOK_ASYNC)
    finally:
        async_module.derive_generation_params = derive
    want = [async_arrival_closed_form(HOOK_ASYNC, t, G_CLIENTS) for t in range(3)]
    print(f"bert_100m async: arrival_weight {hist['arrival_weight'].tolist()}, "
          f"closed form {want}; derive_generation_params (generation, ms): "
          + ", ".join(f"({g}, {ms:.1f})" for g, ms in gen_ms))
    check([float(x) for x in hist["arrival_weight"]] == want,
          f"async: arrival_weight {hist['arrival_weight']} != closed form {want}")
    check(launches["countsketch"] == 3 * -(-G_CLIENTS // STREAM_MB),
          f"async: {launches['countsketch']} B1 calls")
    check(len(gen_ms) == 3 * (HOOK_ASYNC.buffer_rounds - 1),
          f"async: {len(gen_ms)} generation operators derived")


STREAM_F, STREAM_C = 32, 10     # the stream workload's classifier


def stream_loss(p, b):
    logits = b["x"] @ p["W"] + p["b"]
    return -torch.mean(torch.gather(torch.log_softmax(logits, dim=-1), -1,
                                    b["y"][..., None]))


def phase_stream_workload() -> None:
    """Phase 9d: the reference's stream workload (benchmarks/run.py
    ``stream_rows``) at G = 2,048 and 8,192: the 330-parameter linear
    classifier on the Gaussian-mixture sampler, balanced count-sketch at
    ratio 0.25, AMSGrad lr 0.05, client lr 0.1, K = 1, 2 samples a client,
    microbatch 1,024.  The round's own peak (above what it was handed, the
    batch included) must not grow with G by more than the batch's bytes."""
    print("== phase 9d: the stream workload (linear classifier), G = 2,048 "
          "and 8,192 ==")
    sk = SketchConfig(kind="countsketch", ratio=0.25, min_b=64)
    cfg = SAFLConfig(sketch=sk, server=AdaConfig(name="amsgrad", lr=0.05),
                     client_lr=0.1, local_steps=1)
    fresh = lambda: {"W": torch.zeros((STREAM_F, STREAM_C), device="cuda"),
                     "b": torch.zeros((STREAM_C,), device="cuda")}
    plan = make_packing_plan(sk, fresh())
    base_fn = functools.partial(safl_round, cfg, stream_loss, plan=plan)
    rows = {}
    for g in (2_048, 8_192):
        peaks: list = []

        def round_fn(*args, **kwargs):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            out = base_fn(*args, **kwargs)
            torch.cuda.synchronize()
            peaks.append(torch.cuda.max_memory_allocated() - before)
            return out

        sampler = GaussianClsData(ClsDataConfig(
            num_features=STREAM_F, num_classes=STREAM_C, num_clients=g,
            dirichlet_alpha=0.0, seed=0)).device_sampler(2, 1)
        marks = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, _, hist = run_scan(
            round_fn, sampler, fresh(), init_safl(cfg, fresh()), rounds=2,
            key=prng.key(1000), chunk_size=1, microbatch=1024,
            on_chunk=lambda *a: (torch.cuda.synchronize(),
                                 marks.append(time.perf_counter())))
        ms = [(b - a) * 1e3 for a, b in zip([t0] + marks, marks)]
        batch_bytes = g * 2 * (STREAM_F * 4 + 8)
        rows[g] = (max(peaks), batch_bytes)
        print(f"stream G={g}: loss {hist['loss'].tolist()}; round ms "
              f"{', '.join(f'{x:.1f}' for x in ms)} (sampling included); the "
              f"round's peak above its inputs {max(peaks) / 2**20:.3f} MiB; batch "
              f"{batch_bytes / 2**20:.3f} MiB")
        check(all(math.isfinite(x) for x in hist["loss"]), f"stream G={g}: loss")
        for k, v in params.items():
            check(bool(torch.isfinite(v).all()), f"stream G={g}: {k} not finite")
    (p1, b1), (p2, b2) = rows[2_048], rows[8_192]
    print(f"stream: round peak grew by {(p2 - p1) / 2**20:.3f} MiB from G=2,048 to "
          f"8,192, the batch by {(b2 - b1) / 2**20:.3f} MiB")
    check(p2 - p1 <= b2 - b1, f"stream: the round's peak grew by {p2 - p1} bytes "
          f"with G, more than the batch's {b2 - b1}")


# ---------------------------------------------------------------------------
# phase 10: the host runtime (telemetry, shards, supervisor) and launchers
# ---------------------------------------------------------------------------

SPAN_FIELDS = ("t0", "t1", "seconds", "compile")
RECOVERY_FIELDS = ("retry", "t_fault", "t_resume", "depth", "reason")


def check_run_dir(run_dir: str, rounds: int) -> None:
    """The rules of tools/check_telemetry.py (which needs the reference's
    key tuples, equal to the port's: tests/test_torch_obs.py) on a run
    directory: the manifest's required keys; every shard row a metrics
    row of consecutive integer rounds whose other keys are history keys
    with numeric values; every event a span or a recovery with its
    fields; ``rounds`` distinct rounds."""
    with open(os.path.join(run_dir, "manifest.json")) as f:
        man = json.load(f)
    check(all(k in man for k in REQUIRED_KEYS), f"{run_dir}: manifest {sorted(man)}")
    seen: set[int] = set()
    shards = sorted(Path(run_dir).glob("metrics-*.jsonl"))
    check(bool(shards), f"{run_dir}: no metrics shards")
    for path in shards:
        prev = None
        for line in path.read_text().splitlines():
            if not line.strip():
                continue
            row = json.loads(line)
            t = row.get("t")
            check(row.get("kind") == "metrics" and isinstance(t, int)
                  and (prev is None or t == prev + 1), f"{path.name}: row {row}")
            prev = t
            seen.add(t)
            for k, v in row.items():
                check(k in ("kind", "t") or (k in HISTORY_KEYS
                                             and isinstance(v, (int, float))),
                      f"{path.name}: key {k} = {v!r}")
    for line in (Path(run_dir) / "events.jsonl").read_text().splitlines():
        ev = json.loads(line)
        need = {"span": SPAN_FIELDS, "recovery": RECOVERY_FIELDS}.get(ev.get("kind"))
        check(need is not None and all(k in ev for k in need), f"event {ev}")
    check(len(seen) == rounds, f"{run_dir}: {len(seen)} distinct rounds, not {rounds}")


def compare_probes(what: str, card: dict, cpu: dict) -> None:
    """Each probe of a card run against the CPU run's, round by round:
    ``cohort`` and ``clip_frac`` exactly, the rest within phase 3's
    tolerance (its losses' rtol 1e-4, atol 1e-4)."""
    keys = sorted(set(card) & set(PROBE_KEYS_ALL))
    check(set(card) == set(cpu), f"{what}: history keys {sorted(card)} / {sorted(cpu)}")
    worst = {}
    for k in keys:
        a, b = np.asarray(card[k], np.float64), np.asarray(cpu[k], np.float64)
        if k in ("cohort", "clip_frac"):
            check(np.array_equal(a, b), f"{what}: {k} card {a} cpu {b}")
        else:
            check(np.allclose(a, b, rtol=1e-4, atol=1e-4),
                  f"{what}: {k} card {a} cpu {b}")
        worst[k] = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))
    print(f"{what}: probes " + ", ".join(f"{k} {card[k].tolist()}" for k in keys))
    print(f"{what}: largest relative gap card vs cpu " +
          ", ".join(f"{k} {v:.1e}" for k, v in worst.items()))


PROBE_KEYS_ALL = telemetry_module.PROBE_KEYS
TEL_POLICY = dict(num_clients=G_CLIENTS, frac=0.4, seed=123)


def phase_telemetry_smoke() -> None:
    """Phase 10a: two telemetry rounds each of SAFL, FedOPT, SACFL (tau
    0.5) and topk_ef of bert_100m SMOKE under a cohort of 2 of 5, on the
    card against the CPU; then SAFL with and without ``stream=`` on the
    card, bit for bit.  The parameters are held as in phases 3 and 8a:
    topk_ef may move up to one in a thousand of its k kept coordinates
    (a threshold tie), FedOPT up to one in a thousand of d (AMSGrad's
    normalized first step on raw deltas near zero turns float noise into
    a step; ROADMAP section C)."""
    print("== phase 10a: telemetry rounds, bert_100m SMOKE, card against CPU ==")
    t0 = time.perf_counter()
    data = smoke_data()
    sk = dataclasses.replace(MAIN_SKETCH, ratio=0.05, min_b=16)
    tel = Telemetry()
    d = bert_100m_smoke_d()
    runs = {"safl": ({}, 0), "fedopt": ({"fedopt": True}, d // 1000),
            "sacfl": ({"clip_tau": 0.5}, 0),
            "topk_ef": ({"baseline": baseline_cfg("topk_ef", sk)},
                        int(d * sk.ratio) // 1000)}
    for name, (kw, allowed) in runs.items():
        out = {d: run_rounds(bert_100m.SMOKE, sk, data, d, 2, telemetry=tel,
                             policy=UniformParticipation(**TEL_POLICY), **kw)
               for d in ("cuda", "cpu")}
        hg, hc = out["cuda"][2], out["cpu"][2]
        compare_probes(f"{name} telemetry", hg, hc)
        check(list(hg["cohort"]) == [2.0, 2.0], f"{name}: cohort {hg['cohort']}")
        if name == "fedopt":
            check(list(hg["residual"]) == list(hc["residual"]) == [0.0, 0.0],
                  f"fedopt: residual card {hg['residual']} cpu {hc['residual']}")
        if name == "sacfl":
            check("clip_frac" in hg, "sacfl: no clip_frac probe")
        if name == "topk_ef":
            check("ef_norm" in hg and "residual" not in hg, f"topk_ef: {sorted(hg)}")
        compare_card_cpu(f"{name} telemetry", out["cuda"], out["cpu"], allowed)

    seen = []
    with tempfile.TemporaryDirectory() as tmp:
        pa, sa, ha = run_rounds(bert_100m.SMOKE, sk, data, "cuda", 3, telemetry=tel)
        pb, sb, hb = run_rounds(bert_100m.SMOKE, sk, data, "cuda", 3, telemetry=tel,
                                stream=ShardWriter(tmp),
                                per_round=lambda t, p, s, h: seen.append(h))
        rows = load_run(tmp)["rows"]
    check(hb == {} and len(seen) == 3 and len(rows) == 3, "stream: history or rows")
    for k in ha:
        check(np.array_equal(np.concatenate([h[k] for h in seen]), ha[k])
              and [r[k] for r in rows] == [float(x) for x in ha[k]],
              f"stream: {k} differs from the unstreamed run's")
    for k in pa:
        check(torch.equal(pa[k], pb[k]), f"stream: param {k} differs")
    for name in ("m", "v", "vhat"):
        for k in sa[name]:
            check(torch.equal(sa[name][k], sb[name][k]), f"stream: {name}/{k} differs")
    print("stream: params, opt state and history bitwise equal with and without "
          f"stream= on the card; the shard rows equal the history; phase 10a: "
          f"{time.perf_counter() - t0:.1f} s")


def bert_100m_smoke_d() -> int:
    return sum(math.prod(s) for s in param_shapes(bert_100m.SMOKE).values())


class NaNOnce:
    """Client 1's payload is NaN in round ``t`` of the run's original key
    only: unguarded, it poisons the server update, and a rekeyed retry is
    clean (tests/test_faults.py::_TransientFaults)."""

    def __init__(self, key0, t: int):
        self.key0, self.t = key0, t

    def spec(self, t, base_key, device):
        codes = [OK] * G_CLIENTS
        if base_key == self.key0 and t == self.t:
            codes[1] = NAN
        return faults_module._spec_from_codes(
            torch.tensor(codes, dtype=torch.int32, device=device), 1e3)


class Timed:
    """Within ``with``: replaces ``module.name`` with a wrapper that records
    each call's host ms, the device synchronised around it."""

    def __init__(self, module, name: str):
        self.module, self.name, self.ms = module, name, []

    def __enter__(self):
        self.fn = getattr(self.module, self.name)

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t0) * 1e3)
            return out

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def phase_supervised_full(peak4: float) -> int:
    """Phase 10b: six telemetry rounds of bert_100m at full width in chunks
    of 2 under the rollback supervisor (at most 3 snapshots), streamed to
    shards and a manifest, checkpointed every good chunk, with client 1's
    payload NaN in round 3 of the original key.  Returns B1's launches."""
    print("== phase 10b: supervised telemetry run, bert_100m full width ==")
    model, rounds, chunk, fault_t = bert_100m.CONFIG, 6, 2, 3
    cfg = safl_cfg(MAIN_SKETCH)
    key = prng.key(0)

    def fresh():
        params = init_params(model, torch.Generator().manual_seed(0), device="cuda")
        return params, init_safl(cfg, params)

    sampler = BigramLMData(full_data()).device_sampler(batch_per_client=8,
                                                       local_steps=2)
    round_fn = functools.partial(
        safl_round, cfg, lambda p, b: loss_fn(model, p, b), telemetry=Telemetry(),
        plan=make_packing_plan(cfg.sketch, param_shape_tree(model)))
    faults = NaNOnce(key, fault_t)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        launches = supervised_run(tmp, fresh, round_fn, sampler, faults, key,
                                  rounds, chunk, peak4)
    print(f"phase 10b: {time.perf_counter() - t0:.1f} s")
    return launches


def supervised_run(tmp, fresh, round_fn, sampler, faults, key, rounds, chunk,
                   peak4) -> int:
    """Phase 10b's run and checks, its files under ``tmp``.  No frame here
    keeps the initial weights: after the rollback the supervisor holds
    only the relaunched snapshot on the card."""
    import repro_torch.checkpoint.io as checkpoint_io
    run_dir = os.path.join(tmp, "obs")
    stream = ShardWriter(run_dir)
    write_manifest(run_dir, run="chip_smoke 10b", sketch=MAIN_SKETCH,
                   config={"model": "bert_100m", "rounds": rounds, "chunk": chunk},
                   guard_pins=None)
    starts = []

    def launch(p, s, *, key, start_round, on_chunk):
        starts.append(start_round)
        return run_scan(round_fn, sampler, p, s, rounds=rounds, key=key,
                        chunk_size=chunk, start_round=start_round,
                        on_chunk=on_chunk, faults=faults, stream=stream)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cs.LAUNCHES.n = 0
    t0 = time.perf_counter()
    with Timed(telemetry_module, "telemetry_probes") as probes, \
            Timed(supervisor_module, "_host") as snap, \
            Timed(checkpoint_io, "save_checkpoint") as ckpt:
        p, s, hist, log = run_supervised(
            launch, *fresh(), rounds=rounds, key=key,
            config=SupervisorConfig(max_retries=2, keep_snapshots=3),
            ckpt_path=os.path.join(tmp, "ckpt"), stream=stream)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cs.LAUNCHES.n
    peak = peak_gib()
    print(format_recovery_log(log))
    recs = [e for e in load_run(run_dir)["events"] if e["kind"] == "recovery"]
    check(hist == {} and len(log) == 1 and len(recs) == 1
          and log[0]["t_resume"] == recs[0]["t_resume"] == 2,
          f"supervised: recovery log {log}, events {recs}")
    check(starts == [0, 2], f"supervised: launches from rounds {starts}")
    check(all(bool(torch.isfinite(v).all()) for v in p.values()),
          "supervised: final params not finite")
    check(all(bool(torch.isfinite(x).all()) for m in ("m", "v", "vhat")
              for x in s[m].values()), "supervised: final state not finite")
    rows = load_run(run_dir)["rows"]
    last = {r["t"]: r for r in rows}
    check(sorted(last) == list(range(rounds)), f"supervised: rounds {sorted(last)}")
    for t, r in last.items():
        check(all(math.isfinite(r[k]) for k in r if k not in ("kind", "t"))
              and r["cohort"] == G_CLIENTS, f"supervised: round {t} row {r}")
    ran = 2 * chunk + (rounds - 2)              # 0-3, then 2-5 after the rollback
    check(launches == ran, f"supervised: B1 {launches} calls, not one in each "
          f"of the {ran} rounds run")
    check_run_dir(run_dir, rounds)
    spans = [e for e in load_run(run_dir)["events"] if e["kind"] == "span"]
    per_round = [e["seconds"] * 1e3 / (e["t1"] - e["t0"]) for e in spans]
    probe_ms = probes.ms[1:]
    print(f"supervised: {len(rows)} shard rows for {rounds} rounds (last wins); "
          f"residual {[round(last[t]['residual'], 6) for t in range(rounds)]}; "
          f"delta_norm {[round(last[t]['delta_norm'], 6) for t in range(rounds)]}; "
          f"vhat_norm {last[rounds - 1]['vhat_norm']:.6g}; cohort 5 every round")
    print(f"supervised: B1 {launches} calls in {ran} rounds; chunk ms a round "
          f"{', '.join(f'{x:.1f}' for x in per_round)} (spans, with the probes); "
          f"probes ms {', '.join(f'{x:.1f}' for x in probe_ms)} (after the first; "
          f"phase 4's steady rounds above are the same round without them)")
    snap_ms = [a + b for a, b in zip(snap.ms[::2], snap.ms[1::2])]
    print(f"supervised: snapshot (host copy of params and AMSGrad state) ms "
          f"{', '.join(f'{x:.1f}' for x in snap_ms)}; save_checkpoint ms "
          f"{', '.join(f'{x:.1f}' for x in ckpt.ms)}; whole run {wall:.1f} s; peak "
          f"device memory {peak:.2f} GiB (phase 4's in this run: {peak4:.2f} GiB)")
    report = render(run_dir, profile=True)
    print(report)
    check("profile section unavailable" not in report, "report: profile failed")
    del p, s
    return launches


def capture(fn, *args):
    """``fn(*args)``'s result, its standard output (echoed) and wall seconds."""
    import contextlib
    import io
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    print(buf.getvalue(), end="")
    return out, buf.getvalue(), sec


SWEEP_ROUNDS = 20


def phase_launchers() -> None:
    """Phase 10c: the port's launchers on the card: train_lm (lm25m, 20
    rounds, telemetry, faults 0.15 with the sentinel, supervised with 2
    retries), the sketch-size sweep at ``SWEEP_ROUNDS`` rounds a ratio (its
    monotonicity assertion) and the heavy-tail comparison."""
    print("== phase 10c: the launchers on the card ==")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "lm")
        _, out, sec = capture(train_lm.main, [
            "--rounds", "20", "--telemetry", "--faults", "0.15", "--sentinel",
            "--max-retries", "2", "--ckpt", ckpt])
        check("telemetry: rounds=20" in out, "train_lm: no summary line")
        check_run_dir(ckpt + "_obs", 20)
        check(os.path.exists(ckpt + ".npz"), "train_lm: no checkpoint")
    print(f"train_lm: {sec:.1f} s wall (lm25m, 20 rounds, set-up included); "
          "shards valid")
    # 20 of the reference's 80 rounds a ratio (the script's time): the
    # final losses stay monotone in b on the CPU (9.03, 8.82, 6.44, 6.28,
    # 6.18 from b = 0.2% of d to b = d)
    results, _, sec = capture(sketch_size_sweep.main, ["--rounds", str(SWEEP_ROUNDS)])
    check(all(math.isfinite(v) for v in results.values()), f"sweep: {results}")
    print(f"sketch_size_sweep: {sec:.1f} s wall ({SWEEP_ROUNDS} rounds a ratio)")
    errs, _, sec = capture(heavy_tail.main, [])
    check(all(math.isfinite(c[-1]) for c in errs.values()), "heavy_tail: not finite")
    print(f"heavy_tail: {sec:.1f} s wall")


# ---------------------------------------------------------------------------
# phase 11: the paper's Fig. 5 and the model zoo
# ---------------------------------------------------------------------------

FIG5_ITERS, FIG5_PROBES = 20, 2     # the bench's full setting (benchmarks/run.py)


def phase_intrinsic_dim() -> None:
    """Phase 11a: the HVP of bert_100m SMOKE on the card against the CPU,
    then the Fig. 5 estimate at bert_100m's full width and depth on one
    client batch of 16 x 128 tokens (the Lanczos vectors in HBM)."""
    print("== phase 11a: Fig. 5 intrinsic dimension ==")
    smoke = bert_100m.SMOKE
    sbatch = BigramLMData(smoke_data()).client_batch(0, 4, seed=0, device="cpu")
    hv, v = {}, None
    for dev in ("cpu", "cuda"):
        params = init_params(smoke, torch.Generator().manual_seed(0), device=dev)
        mv, d = make_hvp(lambda p, b: loss_fn(smoke, p, b, remat=False), params,
                         {k: t.to(dev) for k, t in sbatch.items()})
        if v is None:
            v = prng.normal(prng.key(1), (d,), "cpu")
        hv[dev] = mv(v.to(dev)).cpu()
    outside = int((~torch.isclose(hv["cuda"], hv["cpu"], rtol=TRAJ_RTOL,
                                  atol=TRAJ_ATOL)).sum())
    print(f"fig5 SMOKE HVP (d = {d:,}, forward-over-reverse): max abs diff card "
          f"vs cpu {float((hv['cuda'] - hv['cpu']).abs().max()):.3e} (largest "
          f"entry {float(hv['cpu'].abs().max()):.3e}); coordinates outside atol "
          f"{TRAJ_ATOL}, rtol {TRAJ_RTOL}: {outside}")
    check(outside == 0, "fig5: the SMOKE HVP differs between card and CPU")

    model = bert_100m.CONFIG
    params = init_params(model, torch.Generator().manual_seed(0), device="cuda")
    batch = BigramLMData(full_data(min(model.vocab_size, 4096))).client_batch(
        0, 16, seed=0, device="cuda")
    # torch.func refuses a checkpointed block: the HVP keeps its activations
    loss = lambda p, b: loss_fn(model, p, b, remat=False)
    mv, d = make_hvp(loss, params, batch)
    v = prng.normal(prng.key(2), (d,), "cuda")
    mv(v)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        mv(v)
    torch.cuda.synchronize()
    hvp_ms = (time.perf_counter() - t0) / 3 * 1e3
    del mv, v
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = intrinsic_dimension(loss, params, batch, FIG5_ITERS, FIG5_PROBES,
                              key=prng.key(0))
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    peak = peak_gib()
    i_dim, lam, tr = out["intrinsic_dim"], out["lambda_max"], out["trace_abs"]
    print(f"fig5 bert_100m full width: d = {d:,}, I = {i_dim:.2f}, lambda_max = "
          f"{lam:.5g}, trace|H| = {tr:.5g}, I/d = {i_dim / d:.3e}; HVP "
          f"{hvp_ms:.1f} ms (forward-over-reverse, 16 x 128 tokens); the "
          f"estimate ({FIG5_ITERS} iterations x {FIG5_PROBES} probes) {sec:.1f} s; "
          f"peak device memory {peak:.2f} GiB (Lanczos vectors "
          f"{FIG5_ITERS * d * 8 / 1e9:.1f} GB)")
    check(all(math.isfinite(x) for x in (i_dim, lam, tr)) and lam > 0
          and 0 < i_dim < d, f"fig5: I {i_dim}, lambda_max {lam}, trace {tr}")
    check(out["nodes"].size == FIG5_ITERS * FIG5_PROBES,
          f"fig5: {out['nodes'].size} Ritz values (a Lanczos run stopped early)")


# llama3.2-1b at full width with 2 of its 16 blocks: its 1.236 B parameters
# at full depth need ~9x phase 4's peak, more than one card holds
LLAMA_2_BLOCKS = dataclasses.replace(llama3_2_1b.CONFIG, num_layers=2)
# phase 11b's models; B1 has an entry at each one's uplink (phase 2)
ZOO_ROUNDS = (("vit_base_86m", vit_base_86m.CONFIG),
              ("llama3_2_1b", LLAMA_2_BLOCKS))


def phase_zoo_rounds() -> dict[str, int]:
    """Phase 11b: three SAFL rounds each of vit_base_86m at full width and
    depth and of llama3.2-1b at full width, 2 blocks, in bfloat16, through
    the count-sketch kernel (G = 5).  Returns B1's calls by entry name."""
    print("== phase 11b: SAFL rounds of the zoo at full width, count-sketch ==")
    counters = {"countsketch": cs.LAUNCHES,
                "countsketch_device": cs.DEVICE_LAUNCHES}
    calls = {}
    for name, model in ZOO_ROUNDS:
        what = name if model.num_layers == get_config(name).num_layers else (
            f"{name} ({model.num_layers} of {get_config(name).num_layers} "
            f"blocks, {str(model.dtype).removeprefix('torch.')})")
        n, _ = phase_full(what, model, MAIN_SKETCH, counters)
        print_cs_launches(what, n)
        calls[f"countsketch_{name}"] = n["countsketch"]
        torch.cuda.empty_cache()
    return calls


# (arch, sequences, text tokens a sequence) of phase 11c's one-block steps:
# whisper's decoder takes its 448 positions after 1,500 audio frames,
# qwen2-vl 256 text tokens after its 256 patches, h2o-danube a sequence
# longer than its 4,096-token window
FAMILY_STEPS = (("dbrx_132b", 2, 512), ("falcon_mamba_7b", 2, 512),
                ("qwen2_vl_7b", 2, 256), ("whisper_large_v3", 2, 448),
                ("qwen1_5_4b", 2, 512), ("qwen2_7b", 2, 512),
                ("h2o_danube_1_8b", 1, 4608))
# a bfloat16 step against float32 on the same weights: each matmul's output
# rounds to 8 significant bits (2^-9 relative), so the gradient, over every
# parameter, is held to a cosine of 0.99.  The losses are printed, not
# held: at init with one block any finite forward gives ~ln(vocab)
ZOO_MIN_COS = 0.99


class RoutingRecorder:
    """Records the top-k experts and the kept mask of every MoE call inside
    the ``with`` (``layers.moe_route`` and ``layers.moe_slots`` wrapped)."""

    def __enter__(self):
        self.topi, self.keep = [], []
        self.orig = layers_module.moe_route, layers_module.moe_slots
        route, slots = self.orig

        def recording_route(*args, **kwargs):
            out = route(*args, **kwargs)
            self.topi.append(out[1].detach().clone())
            return out

        def recording_slots(*args, **kwargs):
            out = slots(*args, **kwargs)
            self.keep.append(out[1].detach().clone())
            return out
        layers_module.moe_route, layers_module.moe_slots = recording_route, recording_slots
        return self

    def __exit__(self, *exc):
        layers_module.moe_route, layers_module.moe_slots = self.orig

    def differences(self, other: "RoutingRecorder") -> str:
        """How many top-k choices, tokens' expert sets and kept-mask
        entries differ from ``other``'s run of the same step."""
        a, b = torch.cat(self.topi), torch.cat(other.topi)
        ka, kb = torch.cat(self.keep), torch.cat(other.keep)
        choices = int((a != b).sum())
        sets = int((a.sort(dim=-1).values != b.sort(dim=-1).values).any(dim=-1).sum())
        kept = int((ka != kb).sum())
        return (f"routing against float32: {choices} of {a.numel():,} top-k choices "
                f"differ, {sets} of {a.shape[0]:,} tokens' expert sets, {kept} of "
                f"{ka.numel():,} kept-mask entries ({int(ka.sum()):,} and "
                f"{int(kb.sum()):,} kept)")


def one_block(model: ModelConfig) -> ModelConfig:
    """The config cut to one scan block (and one encoder block)."""
    return dataclasses.replace(model, num_layers=len(model.scan_blocks()[1]),
                               encoder_layers=min(model.encoder_layers, 1))


def zoo_batch(model: ModelConfig, B: int, S: int, device, dtype) -> dict:
    gen = torch.Generator(device=device).manual_seed(0)
    batch = {"tokens": torch.randint(0, model.vocab_size, (B, S), generator=gen,
                                     device=device)}
    extra = {"vision": ("patch_embeds", model.num_frontend_tokens),
             "audio": ("audio_embeds", model.encoder_seq)}.get(model.frontend)
    if extra:
        batch[extra[0]] = (torch.randn((B, extra[1], model.d_model), generator=gen,
                                       device=device) * 0.02).to(dtype)
    return batch


def grad_step(model: ModelConfig, params: dict, batch: dict, recorder=None):
    """Loss and gradient of one local step: (loss, grads, ms).  A
    ``RoutingRecorder`` records the forward's routing only, not the
    backward's recompute of each block."""
    leaves = [p.requires_grad_(True) for p in params.values()]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recorder if recorder is not None else contextlib.nullcontext():
        loss = loss_fn(model, params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return float(loss.detach()), dict(zip(params, grads)), ms


def phase_zoo_steps() -> None:
    """Phase 11c: each family's client step (loss and gradient) at full
    width, one block, in its dtype and then in float32 on the same weights;
    then every arch's SMOKE loss and gradients, card against CPU."""
    print("== phase 11c: the zoo's client step at full width, one block ==")
    for arch, B, S in FAMILY_STEPS:
        model = one_block(get_config(arch))
        gen = lambda: torch.Generator(device="cuda").manual_seed(0)
        params = init_params(model, gen(), device="cuda")
        d = sum(p.numel() for p in params.values())
        batch = zoo_batch(model, B, S, "cuda", model.dtype)
        grad_step(model, params, batch)                      # warm-up
        torch.cuda.reset_peak_memory_stats()
        r16 = RoutingRecorder()
        loss16, g16, ms16 = grad_step(model, params, batch, r16)
        peak16 = peak_gib()
        del params
        torch.cuda.empty_cache()
        params = init_params(model, gen(), device="cuda")
        params = {k: params[k].float() for k in list(params)}
        model32 = dataclasses.replace(model, dtype=torch.float32)
        batch32 = {k: v.float() if v.is_floating_point() else v
                   for k, v in batch.items()}
        torch.cuda.reset_peak_memory_stats()
        r32 = RoutingRecorder()
        loss32, g32, ms32 = grad_step(model32, params, batch32, r32)
        peak32 = peak_gib()
        dot = n16 = n32 = 0.0
        worst = (2.0, "")
        for k, a in g32.items():
            b = g16[k]
            if a is None or b is None:
                check(a is None and b is None, f"{arch}: {k} unused in one dtype")
                continue
            a, b = a.double(), b.double()
            ab, aa, bb = float((a * b).sum()), float((a * a).sum()), float((b * b).sum())
            dot, n32, n16 = dot + ab, n32 + aa, n16 + bb
            worst = min(worst, (ab / math.sqrt(aa * bb + 1e-300), k))
        cos = dot / math.sqrt(n16 * n32)
        print(f"{arch} (1 block, d = {d:,}, {B} x {S} tokens): {model.dtype} step "
              f"{ms16:.1f} ms, peak {peak16:.2f} GiB, loss {loss16:.5f}; float32 step "
              f"{ms32:.1f} ms, peak {peak32:.2f} GiB, loss {loss32:.5f}; gradient "
              f"cosine {cos:.5f} (lowest leaf {worst[1]} {worst[0]:.4f})")
        if r16.topi:
            print(f"{arch}: {model.dtype} {r16.differences(r32)}")
        check(math.isfinite(loss16) and math.isfinite(loss32),
              f"{arch}: loss {loss16} in {model.dtype}, {loss32} in float32")
        check(cos >= ZOO_MIN_COS, f"{arch}: gradient cosine {cos} across dtypes")
        del params, g16, g32, batch, batch32
        torch.cuda.empty_cache()
    print("jamba_1_5_large_398b (44.2 B parameters a block) and deepseek_v3_671b "
          "(11.5 B a block, 4.5 B outside the blocks) exceed one card at full "
          "width: SMOKE size only (full width waits for the mesh, ROADMAP A-11)")
    for arch in ARCHS:
        model = get_config(arch, smoke=True)
        out = {}
        for dev in ("cpu", "cuda"):
            params = init_params(model, torch.Generator().manual_seed(0), device=dev)
            batch = zoo_batch(model, 2, 20, "cpu", model.dtype)
            loss, grads, _ = grad_step(model, params,
                                       {k: v.to(dev) for k, v in batch.items()})
            out[dev] = loss, {k: g.cpu() for k, g in grads.items() if g is not None}
        (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
        worst = max(float((gg[k] - g).abs().max()) for k, g in gc.items())
        outside = sum(int((~torch.isclose(gg[k], g, rtol=TRAJ_RTOL,
                                          atol=TRAJ_ATOL)).sum())
                      for k, g in gc.items())
        print(f"{arch} SMOKE: loss card {lg:.6f} cpu {lc:.6f}; gradients max abs "
              f"diff {worst:.3e}, outside atol {TRAJ_ATOL}, rtol {TRAJ_RTOL}: {outside}")
        check(gg.keys() == gc.keys() and np.allclose(lg, lc, rtol=1e-4, atol=1e-4)
              and outside == 0, f"{arch} SMOKE: card and CPU differ")


# ---------------------------------------------------------------------------
# phase 12: cached decode and serving (no TPU kernel on this path)
# ---------------------------------------------------------------------------

# 12a's traffic: 8 requests, each a 32-token prompt then 96 greedy tokens
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW, SERVE_MAX_SEQ = 8, 32, 96, 128
SERVE_WARMUP = 4            # calls of a run left out of its median ms a step
PROFILE_STEPS = 8           # decode steps under torch.profiler
# decode against forward: tests/test_models.py::test_decode_matches_forward_dense
DECODE_FWD_TOL = dict(rtol=2e-2, atol=2e-3)
FAMILY_DECODE_STEPS = 16    # 12b: decode steps of each family at B = 2
SMOKE_DECODE_STEPS, SMOKE_MAX_SEQ = 24, 32   # 12c: h2o-danube's 16-slot ring wraps


class DecodeSpans:
    """A torch.profiler range around every call of each decode layer kind
    (the layers of ``models.layers`` and the output head, wrapped in their
    modules inside the ``with``).  The ranges do not nest."""

    TARGETS = ((layers_module, ("apply_norm", "attention_decode",
                                "cross_attention_decode", "mla_attention_decode",
                                "mamba_decode", "mlp", "moe")),
               (model_module, ("_logits",)))

    def __enter__(self):
        self.orig = [(mod, name, getattr(mod, name))
                     for mod, names in self.TARGETS for name in names]
        for mod, name, fn in self.orig:
            setattr(mod, name, self._wrap(name, fn))
        return self

    @staticmethod
    def _wrap(name, fn):
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(f"decode/{name}"):
                return fn(*args, **kwargs)
        return wrapped

    def __exit__(self, *exc):
        for mod, name, fn in self.orig:
            setattr(mod, name, fn)


def profile_decode(model: ModelConfig, params: dict, cache: dict,
                   tokens: torch.Tensor, start: int) -> None:
    """Where a decode step's time goes: ``PROFILE_STEPS`` steps from
    position ``start`` on the host clock (device synchronised), then the
    same steps under torch.profiler with each layer kind in a range: device
    and host ms a step by layer kind, kernels a step, and the device's idle
    share (1 - kernel time / the unprofiled wall time)."""
    pos = torch.arange(start, start + PROFILE_STEPS, device="cuda")

    def steps():
        for i in range(PROFILE_STEPS):
            decode_step(model, params, cache, tokens[:, i:i + 1], pos[i])
    steps()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    with DecodeSpans(), profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        steps()
        torch.cuda.synchronize()
    spans, busy, kernels = {}, 0.0, 0
    for e in prof.events():
        if e.name.startswith("decode/"):
            if e.device_type == torch.autograd.DeviceType.CPU:
                dev, host, n = spans.get(e.name[7:], (0.0, 0.0, 0))
                spans[e.name[7:]] = (dev + e.device_time_total, host + e.cpu_time_total, n + 1)
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            busy += e.device_time_total
            kernels += 1
    busy_ms = busy / 1e3 / PROFILE_STEPS
    check(busy_ms > 0, "decode profile: no device time (torch.profiler saw no kernel)")
    print(f"{model.name} decode profile ({PROFILE_STEPS} steps from position {start}): "
          f"{wall:.3f} ms a step on the host clock; device busy {busy_ms:.3f} ms a step "
          f"in {kernels / PROFILE_STEPS:.0f} kernels: device idle "
          f"{100 * max(0.0, 1 - busy_ms / wall):.1f}% of the step")
    rest = busy_ms
    for name, (dev, host, n) in sorted(spans.items(), key=lambda kv: -kv[1][0]):
        dev_ms = dev / 1e3 / PROFILE_STEPS
        rest -= dev_ms
        print(f"  {name}: device {dev_ms:.3f} ms a step ({100 * dev_ms / busy_ms:.1f}%), "
              f"host {host / 1e3 / PROFILE_STEPS:.3f} ms, {n // PROFILE_STEPS} calls a step")
    print(f"  outside the layers (embedding, residual adds, slicing): device "
          f"{rest:.3f} ms a step ({100 * rest / busy_ms:.1f}%)")


def cache_nbytes(model: ModelConfig, B: int, max_seq: int) -> int:
    """The cache's bytes from ``cache_shapes`` and ``_cache_dtype``."""
    return sum(math.prod(s) * torch.empty((), dtype=_cache_dtype(model, k)).element_size()
               for k, s in cache_shapes(model, B, max_seq).items())


def forward_logits(model: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    h, _ = forward(model, params, batch)
    return _logits(model, params, h)[..., :model.vocab_size]


def check_decode_vs_forward(what: str, dec: torch.Tensor, full: torch.Tensor) -> None:
    """dec, full: (B, S, vocab) float32: the last position's logits and
    every position's within ``DECODE_FWD_TOL``."""
    worst = float((dec - full).abs().max())
    last = torch.allclose(dec[:, -1], full[:, -1], **DECODE_FWD_TOL)
    every = torch.allclose(dec, full, **DECODE_FWD_TOL)
    print(f"{what}: float32 decode against forward, max abs diff {worst:.3e} over "
          f"{dec.shape[1]} positions (rtol {DECODE_FWD_TOL['rtol']}, atol "
          f"{DECODE_FWD_TOL['atol']}): last {last}, every position {every}")
    check(last and every, f"{what}: float32 decode differs from forward")


def phase_serve_full() -> None:
    """Phase 12a: llama3.2-1b served at full width and all 16 blocks in
    bfloat16 through ``launch/serve.run`` (8 requests of a 32-token prompt
    from ``synthetic_lm_batch``, 96 greedy tokens, max_seq 128), twice;
    the step's profile; then the same weights in float32 against
    ``forward`` on the decoded sequence."""
    print("== phase 12a: serving llama3.2-1b at full width and depth ==")
    t0 = time.perf_counter()
    model = llama3_2_1b.CONFIG
    params = init_params(model, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    d = sum(p.numel() for p in params.values())
    prompt = synthetic_lm_batch(prng.key(12), SERVE_BATCH, SERVE_PROMPT,
                                model.vocab_size, "cuda")["tokens"]
    kw = dict(batch=SERVE_BATCH, steps=SERVE_NEW, max_seq=SERVE_MAX_SEQ,
              prompt=prompt, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs = [serve.run(model, params=params, **kw) for _ in range(2)]
    peak = peak_gib()
    out = runs[1]
    want_bytes = cache_nbytes(model, SERVE_BATCH, SERVE_MAX_SEQ)
    for i, r in enumerate(runs):
        ms = r["step_ms"][SERVE_WARMUP:]
        print(f"llama3.2-1b (d = {d:,}, {model.num_layers} blocks, {model.dtype}) run {i + 1}: "
              f"{SERVE_BATCH} requests x ({SERVE_PROMPT} prompt + {SERVE_NEW} new) tokens, "
              f"{len(r['step_ms'])} decode calls in {r['seconds']:.2f} s; median "
              f"{statistics.median(ms):.3f} ms a step (min {min(ms):.3f}, max "
              f"{max(ms):.3f}, after {SERVE_WARMUP} calls), {r['tokens_per_s']:.0f} "
              f"new tokens/s")
    print(f"llama3.2-1b: cache {out['cache_bytes']:,} bytes ({len(out['cache'])} "
          f"tensors; cache_shapes x dtype size: {want_bytes:,}); peak device "
          f"memory {peak:.2f} GiB")
    check(out["cache_bytes"] == want_bytes and
          all(c.is_cuda and c.dtype == _cache_dtype(model, k)
              for k, c in out["cache"].items()),
          "llama3.2-1b: the cache's tensors differ from cache_shapes")
    check(bool(torch.isfinite(out["logits"]).all()), "llama3.2-1b: logits not finite")
    check(torch.equal(runs[0]["tokens"], runs[1]["tokens"]),
          "llama3.2-1b: two runs decode different tokens")
    check(out["tokens"].shape == (SERVE_BATCH, SERVE_PROMPT + SERVE_NEW),
          f"llama3.2-1b: tokens {tuple(out['tokens'].shape)}")
    mid = SERVE_PROMPT + SERVE_NEW // 2
    profile_decode(model, params, out["cache"], out["tokens"][:, mid:], start=mid)
    bf16_tokens = out["tokens"]
    del runs, out
    params = {k: params[k].float() for k in list(params)}
    torch.cuda.empty_cache()
    model32 = dataclasses.replace(model, dtype=torch.float32)
    out32 = serve.run(model32, params=params, keep_logits=True, **kw)
    full = forward_logits(model32, params, {"tokens": out32["tokens"][:, :-1]})
    check_decode_vs_forward("llama3.2-1b", out32["all_logits"].transpose(0, 1), full)
    same = (bf16_tokens[:, SERVE_PROMPT:] == out32["tokens"][:, SERVE_PROMPT:])
    print(f"llama3.2-1b: float32 median {statistics.median(out32['step_ms'][SERVE_WARMUP:]):.3f} "
          f"ms a step; {int(same.sum())} of {same.numel()} bf16 greedy tokens equal "
          f"the float32 ones ({100 * float(same.float().mean()):.1f}%; not checked); "
          f"phase 12a {time.perf_counter() - t0:.1f} s")
    del params, out32, full
    torch.cuda.empty_cache()


def encoder_out(model: ModelConfig, params: dict, audio: torch.Tensor) -> torch.Tensor:
    """The audio encoder's normed output, as ``encode_for_decode`` runs it."""
    B, Te, _ = audio.shape
    e = audio + layers_module.sinusoidal_embed(
        torch.arange(Te, device=audio.device), model.d_model)[None].to(audio.dtype)
    e, _ = model_module._run_blocks(model, model_module.DENSE, params, "enc_layers/", e,
                                    model_module._positions_for(model, B, Te, audio.device),
                                    bidirectional=True)
    return layers_module.apply_norm(model, model_module._sub(params, "enc_norm/"), e)


def phase_decode_families() -> None:
    """Phase 12b: each family's decode at full width with one block (the
    architectures of 11c), 16 steps at B = 2 in its dtype and in float32 on
    the same weights, the float32 run against ``forward``; whisper encodes
    its 1,500 frames first."""
    print("== phase 12b: each family's decode at full width, one block ==")
    t0 = time.perf_counter()
    for arch, _, _ in FAMILY_STEPS:
        model = one_block(get_config(arch))
        params = init_params(model, torch.Generator(device="cuda").manual_seed(0),
                             device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(1)
        tokens = torch.randint(0, model.vocab_size, (2, FAMILY_DECODE_STEPS),
                               generator=gen, device="cuda")
        audio = (torch.randn((2, model.encoder_seq, model.d_model), generator=gen,
                             device="cuda") * 0.02) if model.encoder_layers else None
        run = functools.partial(serve.run, batch=2, steps=1, max_seq=FAMILY_DECODE_STEPS,
                                prompt=tokens, device="cuda", keep_logits=True)
        out = run(model, params=params, audio=audio if audio is None else audio.to(model.dtype))
        lo, ms_lo, cache = out["all_logits"].transpose(0, 1).float(), out["step_ms"], out["cache"]
        nbytes = out["cache_bytes"]
        check(nbytes == cache_nbytes(model, 2, FAMILY_DECODE_STEPS),
              f"{arch}: cache bytes {nbytes}")
        if model.encoder_layers:
            enc = encoder_out(model, params, audio.to(model.dtype))
            xk = (enc @ params["layers/l0/xattn/wk"][0]).reshape(cache["layers/l0/xk"][0].shape)
            ok = torch.equal(cache["layers/l0/xk"][0], xk)
            print(f"{arch}: encode_for_decode over {model.encoder_seq} frames; xk equals "
                  f"enc_out @ wk: {ok}")
            check(ok, f"{arch}: xk differs from enc_out @ wk")
        del cache, out
        params = {k: params[k].float() for k in list(params)}
        model32 = dataclasses.replace(model, dtype=torch.float32)
        out = run(model32, params=params, audio=audio)
        hi, ms_hi = out["all_logits"].transpose(0, 1), out["step_ms"]
        del out
        # decode at B tokens never fills an expert's capacity (8 slots or
        # more for 2 x top-k choices); forward runs at a factor that drops none
        fwd = dataclasses.replace(model32, capacity_factor=max(
            model.capacity_factor, model.num_experts / max(model.moe_top_k, 1)))
        batch = {"tokens": tokens}
        if model.frontend == "vision":
            # decode gives a text token its position on all three M-RoPE
            # rows: plain rope at the same frequencies, without patches
            fwd = dataclasses.replace(fwd, pos_kind="rope", frontend="none",
                                      num_frontend_tokens=0)
        if model.encoder_layers:
            batch["audio_embeds"] = audio
        check_decode_vs_forward(arch, hi, forward_logits(fwd, params, batch))
        gap = float((lo - hi).abs().max())
        print(f"{arch} (1 block, d = {sum(p.numel() for p in params.values()):,}): "
              f"{model.dtype} decode median {statistics.median(ms_lo[2:]):.3f} ms a step, "
              f"float32 {statistics.median(ms_hi[2:]):.3f}; cache {nbytes:,} bytes "
              f"(B = 2, max_seq {FAMILY_DECODE_STEPS}); {model.dtype} logits against "
              f"float32 max abs diff {gap:.3e}")
        check(bool(torch.isfinite(lo).all()), f"{arch}: {model.dtype} logits not finite")
        del params, lo, hi
        torch.cuda.empty_cache()
    print(f"phase 12b {time.perf_counter() - t0:.1f} s")


def phase_decode_smoke() -> None:
    """Phase 12c: every SMOKE arch's decode, teacher-forced for 24 steps at
    max_seq 32 on the card against the CPU from the same weights (logits
    and final caches within phase 3's tolerance), then ``serve.example()``
    card against CPU."""
    print("== phase 12c: every SMOKE arch's decode, card against CPU ==")
    for arch in ARCHS:
        model = get_config(arch, smoke=True)
        gen = torch.Generator().manual_seed(1)
        tokens = torch.randint(0, model.vocab_size, (2, SMOKE_DECODE_STEPS), generator=gen)
        audio = torch.randn((2, model.encoder_seq, model.d_model), generator=gen) * 0.02
        out = {}
        for dev in ("cpu", "cuda"):
            r = serve.run(model, batch=2, steps=1, max_seq=SMOKE_MAX_SEQ,
                          prompt=tokens.to(dev), device=dev, keep_logits=True,
                          params=init_params(model, torch.Generator().manual_seed(0),
                                             device=dev),
                          audio=audio.to(dev) if model.encoder_layers else None)
            out[dev] = {"logits": r["all_logits"].cpu(),
                        **{k: v.cpu() for k, v in r["cache"].items()}}
        worst = max(float((out["cuda"][k] - v).abs().max()) for k, v in out["cpu"].items())
        outside = sum(int((~torch.isclose(out["cuda"][k], v, rtol=TRAJ_RTOL,
                                          atol=TRAJ_ATOL)).sum())
                      for k, v in out["cpu"].items())
        print(f"{arch} SMOKE decode ({SMOKE_DECODE_STEPS} steps, {len(out['cpu']) - 1} "
              f"cache tensors): card against CPU max abs diff {worst:.3e}, outside "
              f"atol {TRAJ_ATOL}, rtol {TRAJ_RTOL}: {outside}")
        check(outside == 0, f"{arch} SMOKE decode: card and CPU differ")
    ex = {dev: serve.example(dev, params=init_params(
        serve.EXAMPLE, torch.Generator().manual_seed(0), dev), keep_logits=True)
        for dev in ("cpu", "cuda")}
    lc, lg = ex["cpu"]["all_logits"], ex["cuda"]["all_logits"].cpu()
    top2 = lc.topk(2, dim=-1).values
    close = ((top2[..., 0] - top2[..., 1]) <= 2 * TRAJ_ATOL).any(dim=-1)
    # calls before the first close one see the same tokens on both devices
    calls = int(close.float().argmax()) if bool(close.any()) else lc.shape[0]
    ok_logits = torch.allclose(lg[:calls + 1], lc[:calls + 1], rtol=TRAJ_RTOL,
                               atol=TRAJ_ATOL)
    same = torch.equal(ex["cuda"]["tokens"][:, :calls + 1].cpu(),
                       ex["cpu"]["tokens"][:, :calls + 1])
    print(f"serve.example: tokens card against CPU equal through call {calls} of "
          f"{lc.shape[0]} (the first whose top-2 margin on the CPU is within "
          f"{2 * TRAJ_ATOL}): {same}; logits there within tolerance: {ok_logits}; "
          f"all {ex['cuda']['tokens'].numel()} tokens equal: "
          f"{torch.equal(ex['cuda']['tokens'].cpu(), ex['cpu']['tokens'])}")
    check(same and ok_logits, "serve.example: card and CPU differ")


# ---------------------------------------------------------------------------
# phase 13: the mesh on torch.distributed (ROADMAP A-11 step 1)
# ---------------------------------------------------------------------------

class CollectiveClock:
    """Host time inside the sharded path's collectives (``models.parallel``'s
    all_reduce, all_gather, reduce-scatter and all_to_all, the forward's
    and, under autograd, the backward's), each between two device
    synchronisations, while inside the ``with``."""

    NAMES = ("_reduce_", "_gather", "_reduce_scatter", "_all_to_all")

    def __init__(self, dev):
        self.dev, self.seconds, self.calls = dev, 0.0, 0

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def __enter__(self):
        self.orig = {n: getattr(parallel, n) for n in self.NAMES}
        for n, fn in self.orig.items():
            setattr(parallel, n, self._wrap(fn))
        return self

    def _wrap(self, fn):
        def timed(*args, **kwargs):
            self._sync()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            self._sync()
            self.seconds += time.perf_counter() - t
            self.calls += 1
            return out
        return timed

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(parallel, n, fn)


MESH_GRID = ((2, 2), ("data", "model"))
MESH_SILO = ((2, 2, 1), ("pod", "data", "model"))
MESH_CLIENTS = 2            # one client a data index of the grid, a pod of the silo
MESH_ROUNDS = 3
# (name, mesh, topology, FedOPT, cohort size or None) of 13a
MESH_SMOKE_CASES = (
    ("cross_device", MESH_GRID, "cross_device", False, None),
    ("cross_device_dp", MESH_GRID, "cross_device_dp", False, None),
    ("cross_silo", MESH_SILO, "cross_silo", False, None),
    ("fedopt", MESH_GRID, "cross_device", True, None),
    ("cohort 1 of 2", MESH_GRID, "cross_device", False, 1))
MESH_SMOKE_SKETCH = dataclasses.replace(MAIN_SKETCH, ratio=0.05, min_b=16)
# 13a's family cases (the sharded client step of MLA + MoE + MTP, Mamba +
# MoE, the encoder and cross-attention): each SMOKE arch in cross_device on
# the grid and in cross_silo on (pod 1, data 2, model 2), tensor
# parallelism, FSDP and the rows over data at once
MESH_SILO_TP = ((1, 2, 2), ("pod", "data", "model"))
MESH_FAMILIES = ("deepseek_v3_671b", "jamba_1_5_large_398b", "whisper_large_v3")
# one round each, the card against the CPU within phases 8a/9a's budget of
# d/1000 coordinates: AMSGrad's first step is a sign, and a router's
# near-tie turns float noise into whole steps: a 1e-7 relative change of
# the weights on the CPU alone moves 338 of jamba's 2,857,344 coordinates
# after one round and 1,762,319 after two (deepseek-v3: 0 and 30,029)
MESH_FAMILY_ROUNDS = 1
MESH_FAMILY_CASES = tuple((f"{arch} {top}", arch, grid, top) for arch in MESH_FAMILIES
                          for top, grid in (("cross_device", MESH_GRID),
                                            ("cross_silo", MESH_SILO_TP)))
# the calls of a mesh round on a rank (names in launch/train.py), timed one
# by one in 13b's breakdown, with their labels
MESH_STEPS = (("client_deltas_sharded", "client_step"),
              ("derive_round_params", "derive_round_params"),
              ("sk_packed_clients", "sketch"), ("_collect", "all_reduce"),
              ("desk_flat", "desk"), ("apply_update", "apply_update"))


# 13c: the hooks at SMOKE size, G = 4 (two clients a client shard): round 1
# of the guard's script poisons client 1, scales client 2 by 1e3 and drops
# client 3
MESH_HOOK_CLIENTS = 4
MESH_HOOK_CODES = ((OK,) * 4, (OK, NAN, BYZANTINE, DROP), (OK,) * 4)
MESH_NORM_MULT = 3.0


def mesh_hook_cases(stream_dir: str) -> tuple:
    """(name, mesh, topology, hooks) of 13c; ``stream_dir`` takes the stream
    case's shards."""
    guard = dict(faults=FaultTable(codes=MESH_HOOK_CODES),
                 sentinel=SentinelConfig(norm_mult=MESH_NORM_MULT))
    return (
        ("microbatch 1", MESH_GRID, "cross_device", dict(microbatch=1)),
        ("int8 codec", MESH_GRID, "cross_device",
         dict(codec=CodecConfig(bits=8, error_feedback=False))),
        ("faults + sentinel", MESH_GRID, "cross_device", guard),
        ("ring stagger", MESH_GRID, "cross_device",
         dict(buffer=AsyncConfig(max_delay=2, delay="stagger"))),
        ("ring uniform + guard", MESH_GRID, "cross_device",
         dict(buffer=AsyncConfig(max_delay=2, delay="uniform"), **guard)),
        ("telemetry", MESH_GRID, "cross_device", dict(telemetry=Telemetry())),
        ("telemetry dp", MESH_GRID, "cross_device_dp", dict(telemetry=Telemetry())),
        ("stream", MESH_GRID, "cross_device",
         dict(telemetry=Telemetry(), stream=ShardWriter(stream_dir))),
        ("guard cross_silo", MESH_SILO, "cross_silo", guard))


# 13d: bert_100m full width, G = 8 on the grid (four clients a client
# shard): the guard's round 1 poisons client 1 (shard 0), scales client 5 by
# 1e3 and drops client 6 (shard 1)
MESH_FULL_CLIENTS = 8
MESH_FULL_ROUNDS = 2        # the guard's round 1 poisons, scales and drops
MESH_FULL_CODES = ((OK,) * 8, (OK, NAN, OK, OK, OK, BYZANTINE, DROP, OK),
                   (OK,) * 8)
# the hooked rounds' calls beyond MESH_STEPS (names in launch/train.py)
MESH_HOOK_STEPS = MESH_STEPS + (
    ("corrupt_payload", "faults"), ("sentinel_validity", "sentinel"),
    ("derive_generation_params", "derive_generation_params"),
    ("sk_packed_clients_wsum", "sketch chunk"), ("encode_decode", "codec"),
    ("_mesh_probes", "probes"), ("_gather_losses", "losses"))


def read_shards(out_dir: str) -> dict[str, np.ndarray]:
    """A run's metric shards as a history: each key's rows in round order."""
    rows = []
    for path in sorted(Path(out_dir).glob("metrics-*.jsonl")):
        rows += [json.loads(line) for line in path.read_text().splitlines()]
    keys = [k for k in rows[0] if k != "kind"] if rows else []
    return {k: np.array([r[k] for r in rows]) for k in keys}


def mesh_plan(model: ModelConfig):
    """The shard-local plan of a rank of the (data 2, model 2) grid."""
    abstract, pspecs = mesh_train._mesh_pspecs(model, "cross_device")
    return make_sharded_packing_plan(MAIN_SKETCH, abstract, pspecs,
                                     dict(zip(MESH_GRID[1], MESH_GRID[0])))


def mesh_data(model: ModelConfig, full: bool) -> LMDataConfig:
    base = full_data(min(model.vocab_size, 4096)) if full else smoke_data()
    return dataclasses.replace(base, num_clients=MESH_CLIENTS)


@functools.lru_cache(maxsize=None)
def mesh_base_sampler(data: LMDataConfig):
    """The device sampler of ``data``, built once a process (13d's bigram
    tables are 8 x 4096^2 floats)."""
    return BigramLMData(data).device_sampler(batch_per_client=8, local_steps=2)


class AudioFrames:
    """A device sampler's batches with an audio model's encoder frames
    beside the tokens: client c's (K, mb, encoder_seq, d_model) of round t
    drawn on the host from a generator seeded (t, c), the same on the card
    and on the CPU, for any rows ``[start, stop)`` of the client axis."""

    def __init__(self, base, model: ModelConfig):
        self.base, self.model = base, model
        self.num_clients = base.num_clients

    def init_state(self, device="cuda"):
        return self.base.init_state(device)

    def sample(self, state, t, start=0, stop=None):
        state, batch = self.base.sample(state, t, start, stop)
        _, K, mb, _ = batch["tokens"].shape
        stop = self.num_clients if stop is None else stop
        shape = (K, mb, self.model.encoder_seq, self.model.d_model)
        frames = [torch.randn(shape, generator=torch.Generator().manual_seed(
            int(t) * 1_000_003 + c)) * 0.02 for c in range(start, stop)]
        batch["audio_embeds"] = torch.stack(frames).to(batch["tokens"].device)
        return state, batch


def mesh_run(mesh, model: ModelConfig, topology: str, sketch: SketchConfig,
             data: LMDataConfig, rounds: int, *, fedopt: bool = False,
             cohort=None, host_loop: bool = False, hooks=None, **scan_kw):
    """``rounds`` mesh rounds on this rank from the weights of seed 0 under
    ``prng.key(0)``: ``run_mesh_scan`` (``scan_kw``: chunk_size, on_chunk),
    or the host loop of the per-round step; ``hooks`` the federated hooks
    (a ``buffer`` gets ``init_mesh_async_state``'s state).  G is
    ``data.num_clients``.  Returns (local params, local state, history,
    pspecs)."""
    hooks = dict(hooks or {})
    cfg = safl_cfg(SketchConfig(kind="none") if fedopt else sketch)
    base = mesh_base_sampler(data)
    if model.encoder_layers:
        base = AudioFrames(base, model)
    smp = mesh_train.mesh_sampler(mesh, base, topology)
    _, pspecs = mesh_train._mesh_pspecs(model, topology)
    params = local_shard(mesh, init_params(model, torch.Generator().manual_seed(0),
                                           device=mesh.device), pspecs)
    acfg = hooks.get("buffer")
    state = (init_safl(cfg, params) if acfg is None else
             mesh_train.init_mesh_async_state(model, cfg, acfg, mesh, params,
                                              topology, data.num_clients))
    policy = (None if cohort is None else UniformParticipation(
        data.num_clients, frac=cohort / data.num_clients, seed=123))
    key = prng.key(0)
    if host_loop:
        step, _ = mesh_train.make_safl_train_step(
            model, cfg, mesh, topology, participation=policy,
            num_clients=data.num_clients,
            **{k: v for k, v in hooks.items() if k != "stream"})
        out = mesh_train.run_mesh_host_loop(
            step, smp, params, state, rounds=rounds, key=key,
            participation=policy, buffer=acfg, faults=hooks.get("faults"),
            sentinel=hooks.get("sentinel"))
    else:
        out = mesh_train.run_mesh_scan(model, cfg, mesh, smp, params, state,
                                       rounds=rounds, key=key, topology=topology,
                                       participation=policy, **hooks, **scan_kw)
    return (*out, pspecs)


def _every_rank(mesh, values: list[float]) -> list[list[float]]:
    """Each rank's ``values``, in rank order, on every rank (through the
    mesh's device: NCCL takes no CPU tensor)."""
    mine = torch.tensor(values, dtype=torch.float64, device=mesh.device)
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, mine)
    return [p.tolist() for p in parts]


def mesh_smoke(mesh, device: str) -> dict:
    """13a, 13c and 15a on one rank: three rounds of each case at bert_100m
    SMOKE and of each family case at its SMOKE size on ``device``; rank 0
    gets every case's gathered params and history (the stream case's from
    its shards), whether the scanned driver equals its host loop on every
    rank (13a's cross_device, 13c's guard and ring), and the supervised
    run's (``mesh_supervised``)."""
    meshes = {MESH_GRID[1]: mesh, MESH_SILO[1]: make_mesh(*MESH_SILO, device=device)}
    silo_tp = make_mesh(*MESH_SILO_TP, device=device)
    out, local = {}, {}
    for name, arch, grid, topology in MESH_FAMILY_CASES:
        m = mesh if grid == MESH_GRID else silo_tp
        model = get_config(arch, smoke=True)
        params, _, hist, pspecs = mesh_run(m, model, topology, MESH_SMOKE_SKETCH,
                                           mesh_data(model, False), MESH_FAMILY_ROUNDS)
        out[name] = ({k: v.cpu() for k, v in gather_tree(m, params, pspecs).items()},
                     None, hist)
    for name, (_, axes), topology, fedopt, cohort in MESH_SMOKE_CASES:
        m = meshes[axes]
        params, state, hist, pspecs = mesh_run(
            m, bert_100m.SMOKE, topology, MESH_SMOKE_SKETCH,
            mesh_data(bert_100m.SMOKE, False),
            MESH_ROUNDS, fedopt=fedopt, cohort=cohort)
        local[name] = (params, state, hist)
        out[name] = ({k: v.cpu() for k, v in gather_tree(m, params, pspecs).items()},
                     None, hist)
    p, s, h, _ = mesh_run(mesh, bert_100m.SMOKE, "cross_device",
                          MESH_SMOKE_SKETCH, mesh_data(bert_100m.SMOKE, False),
                          MESH_ROUNDS, host_loop=True)
    p0, s0, h0 = local["cross_device"]
    same = (np.array_equal(h["loss"], h0["loss"])
            and all(torch.equal(p[k], p0[k]) for k in p)
            and all(torch.equal(s[m][k], s0[m][k]) for m in ("m", "v", "vhat")
                    for k in p))
    out["scan_equals_host_loop"] = min(r[0] for r in _every_rank(mesh, [float(same)])) == 1.0

    data = dataclasses.replace(smoke_data(), num_clients=MESH_HOOK_CLIENTS)
    hooks = {}
    with tempfile.TemporaryDirectory(prefix="mesh_stream_") as tmp:
        for name, (_, axes), topology, kw in mesh_hook_cases(tmp):
            m = meshes[axes]
            params, state, hist, pspecs = mesh_run(
                m, bert_100m.SMOKE, topology, MESH_SMOKE_SKETCH, data,
                MESH_ROUNDS, hooks=kw)
            if "stream" in kw:
                check(hist == {}, "mesh stream: a history came back")
                hist = read_shards(tmp) if m.rank == 0 else {}
            local[name] = (params, state, hist)
            hooks[name] = ({k: v.cpu() for k, v in gather_tree(m, params, pspecs).items()},
                           None, hist)
        same = []
        for name, (_, axes), topology, kw in mesh_hook_cases(tmp):
            if name not in ("faults + sentinel", "ring stagger"):
                continue
            p, s, h, _ = mesh_run(meshes[axes], bert_100m.SMOKE, topology,
                                  MESH_SMOKE_SKETCH, data, MESH_ROUNDS,
                                  host_loop=True, hooks=kw)
            p0, s0, h0 = local[name]
            s, s0 = (s.get("opt", s), s0.get("opt", s0))
            same.append(h.keys() == h0.keys()
                        and all(np.array_equal(h[k], h0[k]) for k in h)
                        and all(torch.equal(p[k], p0[k]) for k in p)
                        and all(torch.equal(s[m][k], s0[m][k])
                                for m in ("m", "v", "vhat") for k in p))
    out["hooks"] = hooks
    out["hooks_scan_equals_host_loop"] = min(
        r[0] for r in _every_rank(mesh, [float(all(same))])) == 1.0
    out["supervised"] = mesh_supervised(mesh)
    return out


def mesh_full(mesh, model: ModelConfig) -> dict:
    """13b on one rank: three rounds of ``model`` (bert_100m at full width),
    chunk 1, B1's count set to 0 just before; the last round timed call by
    call (``MESH_STEPS``, the device synchronised around each, the client
    step's collectives clocked).  Rank 0 gets the losses, its round ms,
    round 1's params gathered, every rank's B1 launches and peak, the
    plan's sizes and the last round's breakdown."""
    topology = "cross_device"
    pspecs = mesh_train._mesh_pspecs(model, topology)[1]
    plan = mesh_train._mesh_plan(model, safl_cfg(MAIN_SKETCH), mesh, topology)[2]
    rounds_ms, params1, times = [], {}, {}
    clock = {}
    coll = CollectiveClock(mesh.device)
    coll.orig = {}
    saved = [(name, getattr(mesh_train, name)) for name, _ in MESH_STEPS]

    def timed(label, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times[label] = times.get(label, 0.0) + (time.perf_counter() - t0) * 1e3
            return out
        return call

    def per_round(t, params, state, hist):
        torch.cuda.synchronize()
        rounds_ms.append((time.perf_counter() - clock["t"]) * 1e3)
        if t == 1:          # round 1's params, off the round's clock
            full = gather_tree(mesh, params, pspecs)
            if mesh.rank == 0:
                params1.update({k: v.cpu() for k, v in full.items()})
            del full
            torch.cuda.synchronize()
        if t == MESH_ROUNDS - 1:        # t rounds done: the last is timed call by call
            for (name, fn), (_, label) in zip(saved, MESH_STEPS):
                setattr(mesh_train, name, timed(label, fn))
            coll.__enter__()
        clock["t"] = time.perf_counter()

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cs.LAUNCHES.n = 0
    clock["t"] = time.perf_counter()
    try:
        params, state, hist, _ = mesh_run(mesh, model, topology, MAIN_SKETCH,
                                          mesh_data(model, True), MESH_ROUNDS,
                                          chunk_size=1, on_chunk=per_round)
    finally:
        coll.__exit__()
        for name, fn in saved:
            setattr(mesh_train, name, fn)
    torch.cuda.synchronize()
    launches, peak = cs.LAUNCHES.n, peak_gib()
    peak_bytes = torch.cuda.max_memory_allocated()
    # a round's arguments on this rank: its shards, its state, its rows
    smp = mesh_train.mesh_sampler(mesh, mesh_base_sampler(mesh_data(model, True)), topology)
    rows = smp.sample(smp.init_state(mesh.device), 0)[1]
    args = storage_bytes(params, state, rows)
    del params, state, rows
    breakdown = {**times, "round": rounds_ms[-1],
                 "collectives": (coll.calls, coll.seconds * 1e3)}
    return dict(loss=hist["loss"], rounds_ms=rounds_ms, params1=params1,
                ranks=_every_rank(mesh, [launches, peak]), breakdown=breakdown,
                argument_bytes=args, peak_bytes=peak_bytes,
                d_total=plan.d_total, b_total=plan.b_total,
                b_bits=torch.empty((), dtype=MAIN_SKETCH.transport_dtype).element_size() * 8)


def mesh_full_hooks(mesh, model: ModelConfig) -> dict:
    """13d on one rank: two rounds of ``model`` (bert_100m at full width)
    on the grid at G = 8 under each of (i) the guard with telemetry and the
    stream, (ii) the ring (``stagger``, ``max_delay=2``) and (iii) the
    streamed fold at ``microbatch=1`` with the int8 codec; chunk 1, every
    call of ``MESH_HOOK_STEPS`` timed (the device synchronised around it),
    B1's count set to 0 just before each run.  Rank 0 gets each run's
    history (the stream's from its shards), round ms, last round's
    breakdown and every generation's ``derive_generation_params`` ms, and
    every rank's B1 launches and peak."""
    data = dataclasses.replace(mesh_data(model, True), num_clients=MESH_FULL_CLIENTS)
    times: dict[str, list[float]] = {}

    def timed(label, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times.setdefault(label, []).append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    saved = [(name, getattr(mesh_train, name)) for name, _ in MESH_HOOK_STEPS]
    out = {}
    with tempfile.TemporaryDirectory(prefix="mesh_stream_") as tmp:
        runs = (
            ("guard", dict(faults=FaultTable(codes=MESH_FULL_CODES),
                           sentinel=SentinelConfig(norm_mult=MESH_NORM_MULT),
                           telemetry=Telemetry(), stream=ShardWriter(tmp))),
            ("ring", dict(buffer=AsyncConfig(max_delay=2, delay="stagger"))),
            ("microbatch 1 + int8 codec",
             dict(microbatch=1, codec=CodecConfig(bits=8, error_feedback=False))))
        for run, hooks in runs:
            rounds_ms, last, gens, clock = [], {}, [], {}
            coll, coll_last = CollectiveClock(mesh.device), []

            def per_round(t, params, state, hist):
                torch.cuda.synchronize()
                rounds_ms.append((time.perf_counter() - clock["t"]) * 1e3)
                last.clear()
                last.update({k: sum(v) for k, v in times.items()})
                gens.append(times.get("derive_generation_params", []))
                times.clear()
                coll_last[:] = [coll.calls, coll.seconds * 1e3]
                coll.calls, coll.seconds = 0, 0.0
                clock["t"] = time.perf_counter()

            for (name, fn), (_, label) in zip(saved, MESH_HOOK_STEPS):
                setattr(mesh_train, name, timed(label, fn))
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            cs.LAUNCHES.n = 0
            times.clear()
            clock["t"] = time.perf_counter()
            try:
                with coll:
                    _, _, hist, _ = mesh_run(mesh, model, "cross_device", MAIN_SKETCH,
                                             data, MESH_FULL_ROUNDS, hooks=hooks,
                                             chunk_size=1, on_chunk=per_round)
            finally:
                for name, fn in saved:
                    setattr(mesh_train, name, fn)
            torch.cuda.synchronize()
            launches, peak = cs.LAUNCHES.n, peak_gib()
            if "stream" in hooks:
                check(hist == {}, "mesh bert_100m: the streamed run returned a history")
                hist = read_shards(tmp) if mesh.rank == 0 else {}
            out[run] = dict(hist=hist, rounds_ms=rounds_ms, breakdown=dict(last),
                            generations=gens, collectives=list(coll_last),
                            ranks=_every_rank(mesh, [launches, peak]))
    return out


def mesh_card_rank(mesh, cpu_done: str, step_refs: str) -> dict:
    """A rank of phase 13 on the card: 13a's and 13c's card half (while the
    CPU ranks run theirs), then, once the file ``cpu_done`` exists (the CPU
    ranks have ended), 13b and 13d on a host with no other ranks, then 13e
    on the same ranks laid out as ``MESH_STEP_GRID`` (its one-process
    references under ``step_refs``), and 16a on those ranks."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke = mesh_smoke(mesh, "cuda")
    while not os.path.exists(cpu_done):
        time.sleep(0.2)
    out = {"smoke": smoke, "full": mesh_full(mesh, bert_100m.CONFIG),
           "hooks": mesh_full_hooks(mesh, bert_100m.CONFIG)}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    step_mesh = make_mesh(*MESH_STEP_GRID, device="cuda")
    out["step"] = mesh_step_ranks(step_mesh, step_refs)
    out["step_seconds"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    out["part"] = part_heads_smoke(step_mesh)
    return out


def mesh_cpu_rank(mesh) -> dict:
    """A rank of 13a's and 13c's CPU half."""
    return mesh_smoke(mesh, "cpu")


def mesh_composition(model: ModelConfig, device="cuda") -> dict:
    """Round 1 of 13b composed in this one process on the card: both
    clients' deltas on the whole weights, each model shard's slice through
    the shard-local plan (B1 at G = 2), the mean, the desk into the shard's
    block of the update, then AMSGrad on the whole tree."""
    cfg = safl_cfg(MAIN_SKETCH)
    sampler = BigramLMData(mesh_data(model, True)).device_sampler(
        batch_per_client=8, local_steps=2)
    batch = sampler.round_batch(0, device)
    params = init_params(model, torch.Generator().manual_seed(0), device=device)
    deltas, _ = safl_module.client_deltas(
        cfg, lambda p, b: loss_fn(model, p, b), params, batch,
        safl_module._f32(cfg.client_lr))
    pspecs = mesh_train._mesh_pspecs(model, "cross_device")[1]
    plan = mesh_plan(model)
    rp = derive_round_params(plan, prng.fold_in(prng.key(0), 0), device)
    update = {k: torch.empty(p.shape, device=device) for k, p in params.items()}
    layout = Mesh(*MESH_GRID)
    for m in range(layout.shape["model"]):
        view = Mesh(layout.sizes, layout.axis_names,
                    rank=layout.rank_of({"data": 0, "model": m}))
        local = local_shard(view, deltas, {k: (None,) + s for k, s in pspecs.items()})
        s = sk_packed_clients(plan, rp, local)
        u = unpack_tree(plan, desk_flat(plan, rp, safl_module.masked_mean(s)),
                        cast=False)
        for k, v in u.items():
            update[k][sharding._block(view, update[k].shape, pspecs[k])] = v
    del deltas
    new, _ = adaptive_module.apply_update(cfg.server, init_safl(cfg, params),
                                          params, update)
    return {k: v.cpu() for k, v in new.items()}


def phase_mesh() -> tuple[dict[str, int], dict]:
    """Phase 13: (a) each topology, FedOPT and a cohort at SMOKE size, and
    the family cases, on four ranks on the card (sharing it through gloo,
    or a card each through NCCL) against four CPU ranks that run beside
    them, and the scanned driver against its host loop on both; (b) three
    bert_100m rounds at full width on (data 2, model 2) with their checks,
    round 1 against the one-process composition, the ranks' B1 launches
    and peaks, and the last round's breakdown; (c) each hook at SMOKE size,
    card against CPU; (d) two bert_100m rounds of each hooked run at full
    width; (e) the sharded client step alone at full width on the same
    ranks (``mesh_step_references`` first, ``report_mesh_client_step``).
    Then 15a's report (``report_mesh_supervised``).  Returns B1's launches
    summed over the ranks: at G = 1 (13b and 13d's streamed fold) and at G =
    4 (13d's guarded and ring rounds); and rank 0's argument bytes and peak
    in 13b and 13e (dbrx_132b, with its step's ms), which 15b holds the
    dry run to, and 16a's results."""
    t_refs = time.perf_counter()
    world = math.prod(MESH_GRID[0])
    shared = choose_backend(world, "cuda") == "gloo"
    where = "sharing the card (gloo)" if shared else "a card each (NCCL)"
    print(f"== phase 13a: the mesh at bert_100m SMOKE, {world} ranks {where} "
          f"against {world} on the CPU (13e's one-process references first) ==")
    step_refs = tempfile.TemporaryDirectory(prefix="mesh_step_")
    refs = mesh_step_references(step_refs.name)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ends = {}
    with step_refs, tempfile.TemporaryDirectory(prefix="mesh_cpu_") as tmp:
        cpu_done = os.path.join(tmp, "done")

        def cpu_half():
            try:
                return spawn(mesh_cpu_rank, *MESH_GRID, device="cpu", timeout=900)
            finally:
                ends["cpu"] = time.perf_counter()
                Path(cpu_done).touch()

        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            cpu_run = pool.submit(cpu_half)
            card = spawn(mesh_card_rank, *MESH_GRID, cpu_done, step_refs.name,
                         device="cuda", timeout=1200)
            cpu = cpu_run.result()
    t1 = time.perf_counter()
    print(f"phase 13: card ranks {t1 - t0:.1f} s (13a to 13e), CPU ranks "
          f"{ends['cpu'] - t0:.1f} s (13a, 13c) beside them")
    for name, *_ in MESH_SMOKE_CASES:
        compare_card_cpu(f"mesh {name}", card["smoke"][name], cpu[name])
    for name, *_ in MESH_FAMILY_CASES:
        d = sum(v.numel() for v in cpu[name][0].values())
        compare_card_cpu(f"mesh {name} SMOKE", card["smoke"][name], cpu[name],
                         allowed=d // 1000)
    for dev, out in (("card", card["smoke"]), ("CPU", cpu)):
        print(f"mesh cross_device on the {dev}: run_mesh_scan bitwise "
              f"run_mesh_host_loop on every rank: {out['scan_equals_host_loop']}")
        check(out["scan_equals_host_loop"],
              f"mesh: the scanned driver differs from its host loop on the {dev}")

    print(f"== phase 13b: bert_100m full width on (data 2, model 2), {world} "
          f"ranks {where} ==")
    full = card["full"]
    n_shards = MESH_GRID[0][1]
    bits = MESH_CLIENTS * n_shards * full["b_total"] * full["b_bits"]
    print(f"mesh bert_100m: shard-local d_total {full['d_total']:,}, b_total "
          f"{full['b_total']:,}; uplink bits a round {bits:,} ({MESH_CLIENTS} "
          f"clients x {n_shards} model shards x b_total x {full['b_bits']})")
    check((full["d_total"], full["b_total"]) == (66_046_464, 1_321_033),
          f"mesh bert_100m: the shard-local plan is {full['d_total']}, "
          f"{full['b_total']}, not the reference's 66,046,464, 1,321,033")
    check(bits == 2 * 2 * 1_321_033 * 32, f"mesh bert_100m: uplink bits {bits}")
    for t, (loss, ms) in enumerate(zip(full["loss"], full["rounds_ms"])):
        print(f"mesh bert_100m round {t}: loss {loss:.5f}  rank 0 ms {ms:.1f}"
              + ("  (with set-up)" if t == 0 else "  (timed call by call)"
                 if t == MESH_ROUNDS - 1 else ""))
        check(math.isfinite(float(loss)), "mesh bert_100m: loss not finite")
    launches = [int(r[0]) for r in full["ranks"]]
    peaks = [r[1] for r in full["ranks"]]
    print(f"mesh bert_100m: B1 launches by rank {launches}; peak device memory "
          f"by rank {', '.join(f'{p:.2f}' for p in peaks)} GiB (sum "
          f"{sum(peaks):.2f} of the card's "
          f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.1f})")
    check(all(n == MESH_ROUNDS for n in launches),
          f"mesh bert_100m: B1 not launched once a round on every rank: {launches}")
    check(sum(peaks) < 75.0, f"mesh bert_100m: the ranks' peaks sum to {sum(peaks):.1f} GiB")
    bd = full["breakdown"]
    total = bd.pop("round")
    calls, coll_ms = bd.pop("collectives")
    bd["rest"] = total - sum(bd.values())
    print(f"mesh bert_100m round breakdown on rank 0 (ms, round {total:.1f}, "
          f"{world} ranks {where}): "
          + ", ".join(f"{k} {v:.1f} ({100 * v / total:.0f}%)" for k, v in bd.items())
          + f"; inside the client step: {calls} collective calls, {coll_ms:.1f} ms "
          f"({100 * coll_ms / bd['client_step']:.0f}% of it)")
    check(calls > 0, "mesh bert_100m: the client step ran no collective")

    want = mesh_composition(bert_100m.CONFIG)
    got = full["params1"]
    d = sum(v.numel() for v in want.values())
    worst = max(float((got[k] - want[k]).abs().max()) for k in want)
    outside = sum(int((~torch.isclose(got[k], want[k], rtol=TRAJ_RTOL,
                                      atol=TRAJ_ATOL)).sum()) for k in want)
    exact = all(torch.equal(got[k], want[k]) for k in want)
    # the sharded client step sums its partial products in another order:
    # a coordinate AMSGrad's normalized step flips is phases 8a/9a's case
    print(f"mesh bert_100m round 1 params (gathered to rank 0) against the "
          f"one-process composition on the card: max abs diff {worst:.3e}, "
          f"coordinates outside phase 3's tolerance {outside} (allowed d/1000 = "
          f"{d // 1000}), bitwise equal {exact}")
    check(got.keys() == want.keys() and outside <= d // 1000,
          "mesh bert_100m: round 1 differs from the one-process composition")
    report_mesh_hooks_smoke(card["smoke"], cpu)
    hooked = report_mesh_hooks_full(card["hooks"], full["b_total"], where)
    report_mesh_client_step(refs, card["step"])
    print(f"phase 13 {time.perf_counter() - t_refs:.1f} s (13e's references "
          f"{t0 - t_refs:.1f} s, its ranks {card['step_seconds']:.1f} s)")
    report_mesh_supervised(card["smoke"]["supervised"], cpu["supervised"])
    dbrx = card["step"]["dbrx_132b"]
    measured = {"13b": {k: full[k] for k in ("argument_bytes", "peak_bytes")},
                "dbrx_132b": {k: dbrx[k] for k in ("argument_bytes", "peak_bytes",
                                                   "step_ms")},
                "part_smoke": card["part"]}
    return ({"countsketch_mesh": sum(launches) + hooked[1],
             "countsketch_mesh_g4": hooked[4]}, measured)


# 13e: the sharded client step alone at full width, one block, one local
# step of one client of 512 tokens in bfloat16, on (data 1, model 4)
MESH_STEP_GRID = ((1, 4), ("data", "model"))
MESH_STEP_ARCHS = ("dbrx_132b", "falcon_mamba_7b")
MESH_STEP_TOKENS = 512


def mesh_step_setup(model: ModelConfig, device) -> tuple:
    """(the SAFL config of one local step, the (1, 1, 1, S) batch)."""
    cfg = dataclasses.replace(safl_cfg(MAIN_SKETCH), local_steps=1)
    batch = zoo_batch(model, 1, MESH_STEP_TOKENS, device, model.dtype)
    return cfg, {k: v[None, None] for k, v in batch.items()}


def block_cosines(mesh, tree: dict, ref: dict, pspecs: dict) -> tuple[dict, float]:
    """({leaf: (cosine, max abs diff)}, the cosine of all leaves laid end to
    end) of ``tree``'s leaves (this rank's blocks, leading dims of 1
    allowed) against the whole leaves of ``ref`` (memory-mapped): every
    rank's block against the same block of the reference, the sums over
    the ranks in one ``all_reduce`` (the gathered leaf's cosine; no rank
    holds a whole leaf).  Pops ``tree``."""
    dev = mesh.device
    sums, gaps = [], []
    for k in pspecs:
        a = tree.pop(k).reshape(-1).to(torch.float32)
        b = ref[k][sharding._block(mesh, ref[k].shape, pspecs[k])].reshape(-1).to(
            dev, torch.float32)
        sums.append(torch.stack([torch.dot(a, b), torch.dot(a, a), torch.dot(b, b)]))
        gaps.append((a - b).abs().max())
        del a, b
    sums, gaps = torch.stack(sums).double(), torch.stack(gaps).double()
    dist.all_reduce(sums)
    dist.all_reduce(gaps, op=dist.ReduceOp.MAX)
    ab, na, nb = sums.sum(0).tolist()
    return ({k: (1.0 if na == nb == 0.0 else ab / math.sqrt(na * nb), gap)
             for k, (ab, na, nb), gap in zip(pspecs, sums.tolist(), gaps.tolist())},
            ab / math.sqrt(na * nb))


def mesh_step_rank(mesh, arch: str, ref_dir: str) -> dict:
    """13e on a rank: its blocks drawn one leaf at a time (``shard_init``);
    the gradient of the step (``sharded_value_and_grad``, which also warms
    the process up), then ``client_deltas_sharded`` timed with its
    collectives; off the clock, each leaf of both against the one-process
    step's (``block_cosines``, from ``ref_dir``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.device
    model = one_block(get_config(arch))
    _, pspecs = mesh_train._mesh_pspecs(model, "cross_device")
    torch.cuda.reset_peak_memory_stats(dev)
    lp = shard_init(mesh, model, pspecs, dev)
    torch.cuda.empty_cache()
    cfg, batch = mesh_step_setup(model, dev)
    torch.cuda.synchronize(dev)
    setup_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    par = mesh_train.train_par(model, mesh, "cross_device", pspecs)
    _, grads = mesh_train.sharded_value_and_grad(
        par, lp, {k: v[0, 0] for k, v in batch.items()})
    setup_peak = max(setup_peak, torch.cuda.max_memory_allocated(dev) / 2**30)
    grads = {k: torch.zeros_like(lp[k]) if g is None else g for k, g in grads.items()}
    grad_cos = block_cosines(mesh, grads, torch.load(os.path.join(ref_dir, "grads.pt"),
                                                     mmap=True), pspecs)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    args = storage_bytes(lp, batch)
    clock = CollectiveClock(dev)
    t0 = time.perf_counter()
    with clock:
        deltas, losses = mesh_train.client_deltas_sharded(
            model, cfg, mesh, "cross_device", lp, batch, safl_module._f32(cfg.client_lr),
            pspecs)
        torch.cuda.synchronize(dev)
    step_ms = (time.perf_counter() - t0) * 1e3
    peak_bytes = torch.cuda.max_memory_allocated(dev)
    peak = peak_bytes / 2**30
    del lp
    torch.cuda.empty_cache()
    delta_cos = block_cosines(mesh, deltas, torch.load(os.path.join(ref_dir, "delta.pt"),
                                                       mmap=True), pspecs)
    return {"loss": float(losses[0]), "grad_cos": grad_cos, "delta_cos": delta_cos,
            "step_ms": step_ms, "collectives": (clock.calls, clock.seconds * 1e3),
            "argument_bytes": args, "peak_bytes": peak_bytes,
            "ranks": _every_rank(mesh, [setup_peak, peak, step_ms])}


def mesh_step_ranks(mesh, ref_dir: str) -> dict:
    """13e's ranks: ``mesh_step_rank`` for each arch, its references under
    ``ref_dir/<arch>``."""
    out = {}
    for arch in MESH_STEP_ARCHS:
        out[arch] = mesh_step_rank(mesh, arch, os.path.join(ref_dir, arch))
        torch.cuda.empty_cache()
    return out


def mesh_step_reference(arch: str, ref_dir: str) -> dict:
    """13e's one-process step of ``arch`` on the card: the gradient and the
    ``client_delta`` saved under ``ref_dir`` in the weights' dtype (a step
    that moves a weight by less than half of it leaves a difference the
    dtype holds exactly: Sterbenz), the card freed after.  Returns the
    loss, the ms, the peak and which leaves' steps the bfloat16 weights
    resolve (at least half the entries that moved moved by more than one
    spacing)."""
    model = one_block(get_config(arch))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(model, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    cfg, batch = mesh_step_setup(model, "cuda")
    mb = {k: v[0] for k, v in batch.items()}
    os.makedirs(ref_dir)
    _, grads, _ = grad_step(model, params, {k: v[0] for k, v in mb.items()})
    torch.save({k: (torch.zeros_like(params[k]) if g is None else g).cpu()
                for k, g in grads.items()}, os.path.join(ref_dir, "grads.pt"))
    del grads
    params = {k: v.detach() for k, v in params.items()}
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    delta, loss = safl_module.client_delta(
        cfg, lambda p, b: loss_fn(model, p, b), params, mb,
        safl_module._f32(cfg.client_lr))
    torch.cuda.synchronize()
    one_ms = (time.perf_counter() - t1) * 1e3
    peak = peak_gib()
    resolved = {k: bool(((d.abs() > 1.5 * torch.finfo(model.dtype).eps
                          * params[k].float().abs()).sum()
                         >= 0.5 * (d != 0).sum()).item())
                for k, d in delta.items()}
    del params
    torch.save({k: v.to(model.dtype).cpu() for k, v in delta.items()},
               os.path.join(ref_dir, "delta.pt"))
    del delta
    torch.cuda.empty_cache()
    return {"loss": float(loss), "ms": one_ms, "peak": peak, "resolved": resolved,
            "seconds": time.perf_counter() - t0}


def mesh_step_references(ref_dir: str) -> dict:
    """13e's one-process references, one ``mesh_step_reference`` for each
    arch under ``ref_dir/<arch>``, after checking that every leaf divides
    over ``MESH_STEP_GRID``."""
    layout = Mesh(*MESH_STEP_GRID)
    grid = dict(zip(MESH_STEP_GRID[1], MESH_STEP_GRID[0]))
    refs = {}
    for arch in MESH_STEP_ARCHS:
        model = one_block(get_config(arch))
        _, pspecs = mesh_train._mesh_pspecs(model, "cross_device")
        for k, shape in param_shapes(model).items():     # raises where a dim does not divide
            sharding._block(layout, shape, pspecs[k], 0)
        refs[arch] = ref = mesh_step_reference(arch, os.path.join(ref_dir, arch))
        print(f"13e {arch}: every one of its {len(pspecs)} leaves divides over {grid}; "
              f"one-process client_delta {ref['ms']:.1f} ms, peak {ref['peak']:.2f} GiB, "
              f"loss {ref['loss']:.5f} (set-up, gradient and save "
              f"{ref['seconds'] - ref['ms'] / 1e3:.1f} s)")
    return refs


def report_mesh_client_step(refs: dict, got: dict) -> None:
    """Phase 13e's report: for dbrx_132b (MoE) and falcon_mamba_7b (Mamba)
    at full width, one block, the sharded client step (``mesh_step_rank``)
    against the one-process step (``mesh_step_reference``),
    ``check_client_step`` each."""
    world = math.prod(MESH_STEP_GRID[0])
    grid = dict(zip(MESH_STEP_GRID[1], MESH_STEP_GRID[0]))
    print(f"== phase 13e: the sharded client step at full width, one block, "
          f"{MESH_STEP_TOKENS} tokens, bf16, {world} ranks on {grid} ==")
    for arch in MESH_STEP_ARCHS:
        check_client_step(arch, refs[arch], got[arch])


def check_client_step(arch: str, ref: dict, out: dict) -> None:
    """One arch's sharded client step against its one-process step.  Each
    leaf's gradient is held to a cosine of ``ZOO_MIN_COS`` (partial sums
    are rounded to bfloat16 before the row-parallel sum, 11c's reason),
    and so is the delta: all leaves laid end to end, and each leaf whose
    step the bfloat16 weights resolve.  A step below half a weight's
    bfloat16 spacing (the norms' scales at 1.0 take steps of 2^-8) leaves
    a delta of whole spacings whose pattern turns on the step's last bits:
    those leaves' delta cosines are printed, their gradients checked.
    Then the ranks' peaks."""
    pspecs = mesh_train._mesh_pspecs(one_block(get_config(arch)), "cross_device")[1]
    (gcos, g_all), (dcos, d_all) = out["grad_cos"], out["delta_cos"]
    calls, coll_ms = out["collectives"]
    print(f"{arch}: sharded step {out['step_ms']:.1f} ms on rank 0 after a warm-up "
          f"({calls} collective calls, {coll_ms:.1f} ms inside them), loss "
          f"{out['loss']:.5f} (one process {ref['loss']:.5f}, {ref['ms']:.1f} ms)")
    for k in pspecs:
        print(f"  {k}: gradient cosine {gcos[k][0]:.5f} (max abs diff "
              f"{gcos[k][1]:.3e}); delta cosine {dcos[k][0]:.5f} (max abs diff "
              f"{dcos[k][1]:.3e})" + ("" if ref["resolved"][k] else
                                      ", the step below its weights' spacing"))
    print(f"{arch}: all leaves laid end to end: gradient cosine {g_all:.5f}, delta "
          f"cosine {d_all:.5f}")
    peaks = [max(r[0], r[1]) for r in out["ranks"]]
    for i, r in enumerate(out["ranks"]):
        print(f"  rank {i}: peak {r[0]:.2f} GiB building its shards and the "
              f"gradient, {r[1]:.2f} GiB in the step; step {r[2]:.1f} ms")
    print(f"{arch}: the ranks' peaks sum to {sum(peaks):.2f} GiB (one process "
          f"{ref['peak']:.2f})")
    check(math.isfinite(out["loss"])
          and abs(out["loss"] - ref["loss"]) <= 1e-2 * abs(ref["loss"]),
          f"{arch}: sharded loss {out['loss']} against {ref['loss']}")
    low = [k for k in pspecs if gcos[k][0] < ZOO_MIN_COS
           or (ref["resolved"][k] and dcos[k][0] < ZOO_MIN_COS)]
    check(not low and min(g_all, d_all) >= ZOO_MIN_COS,
          f"{arch}: cosines below {ZOO_MIN_COS}: {low}, {g_all}, {d_all}")
    check(sum(peaks) < 75.0, f"{arch}: the ranks' peaks sum to {sum(peaks):.1f} GiB")


# ---------------------------------------------------------------------------
# phase 14: sharded serving on the mesh
# ---------------------------------------------------------------------------

# (name, serve layout, fsdp): dryrun's --serve-layout values, and FSDP
SERVE_MESH_LAYOUTS = (("default", "default", False), ("fsdp", "default", True),
                      ("flat", "flat", False))
SERVE_MESH_B, SERVE_MESH_MAX_SEQ = 4, 32    # 14a: every SMOKE arch
SERVE_MESH_STEPS, SERVE_MESH_PREFILL = 8, 16    # 14a: decode steps, prefill tokens
SERVE_MESH_FULL = ("default", "flat")       # 14b's layouts
# 14b's greedy tokens a request by layout (12a's 96 cut to fit the script's
# time): the flat layout's four-rank calls make a step ~2-3 times the
# default's, so it runs fewer of them
SERVE_MESH_NEW = {"default": 40, "flat": 16}
# 14b's blocks by layout: the flat layout serves 4 of llama3.2-1b's 16
# (its one-process references at the same depth)
SERVE_MESH_BLOCKS = {"default": 16, "flat": 4}


def serve_mesh_model(layout: str) -> ModelConfig:
    """14b's llama3.2-1b for ``layout``: full width, ``SERVE_MESH_BLOCKS``."""
    return dataclasses.replace(llama3_2_1b.CONFIG, num_layers=SERVE_MESH_BLOCKS[layout])
SERVE_MESH_F32_STEPS = 8    # 14b: float32 steps teacher-forced on the prompt
SERVE_MESH_TIMED = 8        # 14b: greedy steps run with the collectives timed
                            # (left out of the median ms a step)
# 14b's float32 gap to the one-process decode, besides 12a's tolerance: sums
# in another order give ~1e-5 (PERF.md); a sum or a softmax done in
# bfloat16 would be ~1e-2 off
SERVE_MESH_F32_ATOL = 1e-4


def outside_tol(got: torch.Tensor, want: torch.Tensor) -> tuple[float, int]:
    """(max abs diff, entries outside phase 3's tolerance)."""
    got, want = got.float(), want.float()
    return (float((got - want).abs().max()),
            int((~torch.isclose(got, want, rtol=TRAJ_RTOL, atol=TRAJ_ATOL)).sum()))


def rank_rows(mesh, t: torch.Tensor, entry) -> torch.Tensor:
    """This rank's rows of ``t`` (its batch dim cut as ``entry``)."""
    return local_shard(mesh, {"t": t}, {"t": (entry,) + (None,) * (t.dim() - 1)})["t"]


def serve_mesh_smoke(mesh) -> dict:
    """14a on a rank: every SMOKE arch's decode in each layout, teacher-
    forced from the same weights as the one-process ``decode_step`` this
    rank runs on its device, the logits and the gathered caches against
    it; the prefill's blocks against ``make_prefill_step``'s logits."""
    dev = mesh.device
    B, max_seq, steps = SERVE_MESH_B, SERVE_MESH_MAX_SEQ, SERVE_MESH_STEPS
    out = {}
    for arch in ARCHS:
        model = get_config(arch, smoke=True)
        params = init_params(model, torch.Generator().manual_seed(0), device=dev)
        gen = torch.Generator().manual_seed(1)
        tokens = torch.randint(0, model.vocab_size, (B, steps), generator=gen).to(dev)
        audio = (torch.randn((B, model.encoder_seq, model.d_model), generator=gen)
                 * 0.02).to(dev)
        cache = init_cache(model, B, max_seq, dev)
        if model.encoder_layers:
            model_module.encode_for_decode(model, params, cache, audio)
        want = torch.stack([decode_step(model, params, cache, tokens[:, t:t + 1],
                                        torch.tensor(t, device=dev))[0]
                            for t in range(steps)])
        res = {}
        for name, layout, fsdp in SERVE_MESH_LAYOUTS:
            step = mesh_train.make_serve_step(model, mesh, layout=layout, fsdp=fsdp,
                                              batch=B, max_seq=max_seq)
            par = step.par
            entry = mesh_train.serve_specs(model, mesh, B, max_seq, layout=layout,
                                           fsdp=fsdp)[2][0]
            lp = local_shard(mesh, params, par.pspecs)
            lc = local_shard(mesh, init_cache(model, B, max_seq, dev), par.cspecs)
            rows = rank_rows(mesh, tokens, entry)
            if model.encoder_layers:
                parallel.encode_for_decode(par, lp, lc, rank_rows(mesh, audio, entry))
            got = torch.stack([step(lp, lc, rows[:, t:t + 1], torch.tensor(t, device=dev))[0]
                               for t in range(steps)])
            got = gather_tree(mesh, {"l": got}, {"l": (None, entry, None)})["l"]
            whole = gather_tree(mesh, lc, par.cspecs)
            errs = [outside_tol(got, want)] + [outside_tol(whole[k], cache[k]) for k in cache]
            res[name] = (max(e for e, _ in errs), sum(n for _, n in errs))
        batch = {"tokens": torch.randint(0, model.vocab_size, (B, SERVE_MESH_PREFILL),
                                         generator=gen).to(dev)}
        if model.frontend == "vision":
            batch["patch_embeds"] = torch.randn(
                (B, model.num_frontend_tokens, model.d_model), generator=gen).to(dev)
        if model.encoder_layers:
            batch["audio_embeds"] = audio
        want = mesh_train.make_prefill_step(model)(params, batch)
        bspecs = mesh_train.infer_batch_pspecs(batch, mesh_train.data_axes_of(mesh), mesh)
        for fsdp in (False, True):
            step = mesh_train.make_prefill_step(model, mesh, fsdp=fsdp, batch=B)
            blk = step(local_shard(mesh, params, step.par.pspecs),
                       local_shard(mesh, batch, bspecs))
            cut = local_shard(mesh, {"l": want}, {"l": (bspecs["tokens"][0], "model")})["l"]
            err, n = outside_tol(blk, cut)
            every = _every_rank(mesh, [err, n, float(blk.shape == cut.shape)])
            res[f"prefill/{'fsdp' if fsdp else 'default'}"] = (
                max(r[0] for r in every), int(sum(r[1] for r in every)),
                all(r[2] == 1.0 for r in every))
        out[arch] = res
    return out


def shard_init(mesh, model: ModelConfig, pspecs: dict, dev) -> dict:
    """This rank's blocks of ``init_params(model, a generator seeded 0 on
    dev)``: each leaf drawn in ``init_params``'s order, cut, and dropped,
    so no rank holds the whole weights."""
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for path, shape in param_shapes(model).items():
        leaf = model_module._init_leaf(gen, path, shape, model)
        out[path] = leaf[sharding._block(mesh, shape, pspecs[path])].clone()
        del leaf
    return out


def block_bytes(mesh, shapes: dict, specs: dict, dtype_of) -> int:
    """The bytes of this rank's blocks of leaves of ``shapes`` under ``specs``."""
    return sum(math.prod(s.stop - s.start for s in sharding._block(mesh, shape, specs[k]))
               * torch.empty((), dtype=dtype_of(k)).element_size()
               for k, shape in shapes.items())


def serve_mesh_full(mesh, prompt: torch.Tensor, f32_paths: dict) -> dict:
    """14b on a rank: llama3.2-1b served from the rank's blocks in each of
    ``SERVE_MESH_FULL``'s layouts at ``serve_mesh_model``'s depth (the
    prompt teacher-forced, then ``SERVE_MESH_NEW`` greedy tokens); each
    step timed on the device, the first ``SERVE_MESH_TIMED`` greedy steps
    also with the collectives timed; the blocks' bytes and the peak memory;
    then the same blocks in float32, teacher-forced on the prompt, the
    logits (rank 0) against the one-process float32 decode's, saved at
    ``f32_paths[layout]``."""
    dev = mesh.device
    cuda = dev.type == "cuda"
    B, P = prompt.shape
    res = {}
    for layout in SERVE_MESH_FULL:
        model = serve_mesh_model(layout)
        model32 = dataclasses.replace(model, dtype=torch.float32)
        calls = P + SERVE_MESH_NEW[layout] - 1
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        step = mesh_train.make_serve_step(model, mesh, layout=layout, batch=B,
                                          max_seq=SERVE_MAX_SEQ)
        par = step.par
        entry = mesh_train.serve_specs(model, mesh, B, SERVE_MAX_SEQ, layout=layout)[2][0]
        lp = shard_init(mesh, model, par.pspecs, dev)
        shapes = cache_shapes(model, B, SERVE_MAX_SEQ)

        def zero_cache(m):
            return {k: torch.zeros([sl.stop - sl.start for sl in
                                    sharding._block(mesh, s, par.cspecs[k])],
                                   dtype=_cache_dtype(m, k), device=dev)
                    for k, s in shapes.items()}
        lc = zero_cache(model)
        nbytes = [sum(v.numel() * v.element_size() for v in lp.values()),
                  block_bytes(mesh, param_shapes(model), par.pspecs, lambda k: model.dtype),
                  sum(v.numel() * v.element_size() for v in lc.values()),
                  block_bytes(mesh, shapes, par.cspecs, lambda k: _cache_dtype(model, k))]
        if cuda:
            torch.cuda.synchronize(dev)
        setup_s = time.perf_counter() - t0
        setup_peak = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else 0.0
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        rows = rank_rows(mesh, prompt.to(dev), entry)
        seq = torch.zeros((rows.shape[0], SERVE_MAX_SEQ), dtype=torch.int64, device=dev)
        seq[:, :P] = rows
        positions = torch.arange(calls, device=dev)
        clock, timed_s, marks = CollectiveClock(dev), 0.0, []
        for t in range(calls):
            if cuda:
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()
            if P <= t < P + SERVE_MESH_TIMED:
                with clock:
                    clock._sync()
                    t1 = time.perf_counter()
                    logits, lc = step(lp, lc, seq[:, t:t + 1], positions[t])
                    clock._sync()
                    timed_s += time.perf_counter() - t1
            else:
                logits, lc = step(lp, lc, seq[:, t:t + 1], positions[t])
            if t >= P - 1:
                seq[:, t + 1] = torch.argmax(logits, dim=-1)
        if cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
            torch.cuda.synchronize(dev)
        step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        peak = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else 0.0
        tokens = gather_tree(mesh, {"t": seq}, {"t": (entry, None)})["t"]
        del lc, logits
        lp = {k: v.float() for k, v in lp.items()}
        step32 = mesh_train.make_serve_step(model32, mesh, layout=layout, batch=B,
                                            max_seq=SERVE_MAX_SEQ)
        lc = zero_cache(model32)
        got = torch.stack([step32(lp, lc, seq[:, t:t + 1], positions[t])[0]
                           for t in range(SERVE_MESH_F32_STEPS)])
        got = gather_tree(mesh, {"l": got}, {"l": (None, entry, None)})["l"]
        f32 = None
        if mesh.rank == 0:
            want = torch.load(f32_paths[layout]).to(dev)
            f32 = (float((got - want).abs().max()),
                   bool(torch.allclose(got, want, **DECODE_FWD_TOL)))
        del lp, lc, got
        res[layout] = dict(step_ms=step_ms, tokens=tokens.cpu(), f32=f32,
                           ranks=_every_rank(mesh, nbytes + [setup_peak, peak, setup_s]),
                           timed_ms=1e3 * timed_s / SERVE_MESH_TIMED,
                           coll_share=clock.seconds / timed_s,
                           coll_calls=clock.calls / SERVE_MESH_TIMED)
    return res


def serve_mesh_rank(mesh, prompt: torch.Tensor, f32_paths: dict) -> dict:
    """A rank of phase 14 on the card: 14a, then 14b at llama3.2-1b's full
    width and depth; with the TPU kernels' counterparts' launches in this
    process (the path reaches none)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counts = kernel_counts()
    for c in counts:
        c.n = 0
    t0 = time.perf_counter()
    smoke = serve_mesh_smoke(mesh)
    t1 = time.perf_counter()
    full = serve_mesh_full(mesh, prompt, f32_paths)
    return {"smoke": smoke, "full": full, "seconds": (t1 - t0, time.perf_counter() - t1),
            "launches": _every_rank(mesh, [float(sum(c.n for c in counts))])}


def phase_serve_mesh() -> None:
    """Phase 14: sharded serving (``make_serve_step``/``make_prefill_step``
    with a live mesh, ``models/parallel.py``) on four ranks sharing the
    card through gloo: (a) every SMOKE arch in the default, FSDP and flat
    layouts against the one-process steps on the card; (b) llama3.2-1b at
    full width and depth in bfloat16 in the default and flat layouts,
    against the one-process ``serve.run`` (greedy tokens) and, in float32,
    the one-process decode (logits)."""
    print("== phase 14: sharded serving on the mesh, one-process references ==")
    t0 = time.perf_counter()
    prompt = synthetic_lm_batch(prng.key(12), SERVE_BATCH, SERVE_PROMPT,
                                llama3_2_1b.CONFIG.vocab_size, "cuda")["tokens"]
    world = math.prod(MESH_GRID[0])
    where = ("sharing the card (gloo)" if choose_backend(world, "cuda") == "gloo"
             else "a card each (NCCL)")
    one, one_ms = {}, {}
    with tempfile.TemporaryDirectory(prefix="serve_mesh_") as tmp:
        f32_paths = {}
        for layout in SERVE_MESH_FULL:
            model = serve_mesh_model(layout)
            params = init_params(model, torch.Generator(device="cuda").manual_seed(0),
                                 device="cuda")
            one[layout] = serve.run(model, params=params, batch=SERVE_BATCH,
                                    steps=SERVE_MESH_NEW[layout], max_seq=SERVE_MAX_SEQ,
                                    prompt=prompt, device="cuda")
            one_ms[layout] = statistics.median(one[layout]["step_ms"][SERVE_WARMUP:])
            params = {k: params[k].float() for k in list(params)}
            out32 = serve.run(dataclasses.replace(model, dtype=torch.float32),
                              params=params, batch=SERVE_BATCH, steps=1,
                              max_seq=SERVE_MAX_SEQ,
                              prompt=prompt[:, :SERVE_MESH_F32_STEPS], device="cuda",
                              keep_logits=True)
            del params
            f32_paths[layout] = os.path.join(tmp, f"logits32_{layout}.pt")
            torch.save(out32["all_logits"].cpu(), f32_paths[layout])
            del out32
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        print(f"one-process references {t1 - t0:.1f} s; {world} ranks {where}")
        got = spawn(serve_mesh_rank, *MESH_GRID, prompt.cpu(), f32_paths, device="cuda",
                    timeout=900)
    print(f"phase 14 ranks {time.perf_counter() - t1:.1f} s (14a {got['seconds'][0]:.1f} s, "
          f"14b {got['seconds'][1]:.1f} s on rank 0)")
    print("== phase 14a: every SMOKE arch sharded on (data 2, model 2), against one "
          "process on the card ==")
    for arch, res in got["smoke"].items():
        print(f"{arch}: " + "; ".join(
            f"{name} max abs diff {v[0]:.3e}, outside {v[1]}" for name, v in res.items()))
        for name, v in res.items():
            check(v[1] == 0 and (len(v) < 3 or v[2]),
                  f"{arch} sharded {name}: differs from the one-process step")
    print(f"== phase 14b: llama3.2-1b at full width, blocks {SERVE_MESH_BLOCKS} of 16, "
          f"{SERVE_BATCH} requests x ({SERVE_PROMPT} prompt + {SERVE_MESH_NEW} new) "
          f"tokens, {world} ranks {where} ==")
    for layout, r in got["full"].items():
        model = serve_mesh_model(layout)
        w_have, w_want, c_have, c_want = (int(x) for x in r["ranks"][0][:4])
        timed = range(SERVE_PROMPT, SERVE_PROMPT + SERVE_MESH_TIMED)
        ms = [m for t, m in enumerate(r["step_ms"]) if t >= SERVE_WARMUP and t not in timed]
        new = [m for t, m in enumerate(r["step_ms"]) if t >= SERVE_PROMPT - 1
               and t not in timed]
        n_tok = SERVE_PROMPT + SERVE_MESH_NEW[layout]
        same = (r["tokens"][:, :n_tok] == one[layout]["tokens"].cpu())[:, SERVE_PROMPT:]
        print(f"llama3.2-1b {layout}: rank 0 median {statistics.median(ms):.3f} ms a step "
              f"(min {min(ms):.3f}, max {max(ms):.3f}; one process "
              f"{one_ms[layout]:.3f}); "
              f"{SERVE_BATCH * len(new) / (sum(new) / 1e3):.0f} new tokens/s (steps "
              f"without the clock); {SERVE_MESH_TIMED} steps with the collectives timed "
              f"{r['timed_ms']:.3f} ms a step, {r['coll_calls']:.0f} collective calls a "
              f"step, {100 * r['coll_share']:.1f}% of it inside them")
        for i, rk in enumerate(r["ranks"]):
            print(f"  rank {i}: weight blocks {int(rk[0]):,} bytes (param_shapes: "
                  f"{int(rk[1]):,}), cache blocks {int(rk[2]):,} (cache_shapes: "
                  f"{int(rk[3]):,}); peak {rk[4]:.2f} GiB set-up, {rk[5]:.2f} GiB "
                  f"serving; set-up {rk[6]:.1f} s")
            check(rk[0] == rk[1] and rk[2] == rk[3],
                  f"llama3.2-1b {layout}: rank {i}'s blocks differ from the layout")
        print(f"llama3.2-1b {layout}: of the bytes of the whole model {w_have / sum(
              math.prod(s) * 2 for s in param_shapes(model).values()):.4f}, of the "
              f"cache {c_have / cache_nbytes(model, SERVE_BATCH, SERVE_MAX_SEQ):.4f}; "
              f"{int(same.sum())} of {same.numel()} greedy tokens equal the one-process "
              f"serve.run's ({100 * float(same.float().mean()):.1f}%; not checked: bf16 "
              f"sums in another order)")
        check(torch.equal(r["tokens"][:, :SERVE_PROMPT], prompt.cpu()),
              f"llama3.2-1b {layout}: the prompt came back changed")
        err, ok = r["f32"]
        print(f"llama3.2-1b {layout}: float32, {SERVE_MESH_F32_STEPS} teacher-forced "
              f"steps against the one-process decode: max abs diff {err:.3e} (rtol "
              f"{DECODE_FWD_TOL['rtol']}, atol {DECODE_FWD_TOL['atol']}): {ok}; "
              f"within {SERVE_MESH_F32_ATOL:g}: {err <= SERVE_MESH_F32_ATOL}")
        check(ok, f"llama3.2-1b {layout}: float32 sharded decode differs")
        check(err <= SERVE_MESH_F32_ATOL,
              f"llama3.2-1b {layout}: float32 sharded decode further than "
              f"{SERVE_MESH_F32_ATOL:g} from the one-process decode")
    launches = int(sum(r[0] for r in got["launches"]))
    print(f"phase 14 {time.perf_counter() - t0:.1f} s; the sharded serving path launched "
          f"{launches} of the TPU kernels' counterparts (it reaches none)")


# the probes card against CPU: float32 sums over ~3e5 coordinates in other
# orders, and AMSGrad's moments after the noise of phase 3's tolerance
MESH_PROBE_RTOL = 1e-3


def report_mesh_hooks_smoke(card: dict, cpu: dict) -> None:
    """13c's checks: each hooked run card against CPU within phase 3's
    tolerance, the counters and ``uplink_bits`` equal, ``arrival_weight``
    within 1e-6 and the probes within ``MESH_PROBE_RTOL``, the guard's
    counters the script's, and the scan bitwise its host loop (guard,
    ring) on both."""
    print(f"== phase 13c: the hooks at bert_100m SMOKE, G = {MESH_HOOK_CLIENTS} "
          f"(two clients a client shard), card against CPU ==")
    d = sum(math.prod(s) for s in param_shapes(bert_100m.SMOKE).values())
    for name, _, _, kw in mesh_hook_cases(tempfile.gettempdir()):
        got, want = card["hooks"][name], cpu["hooks"][name]
        # the codec turns the devices' float noise into whole rounding
        # levels: phase 9a's budget of coordinates outside the tolerance
        compare_card_cpu(f"mesh {name}", got, want,
                         allowed=d // 1000 if "codec" in kw else 0)
        hg, hc = got[2], want[2]
        check(hg.keys() == hc.keys(), f"mesh {name}: history keys differ")
        for k in hg:
            if k in ("n_dropped", "n_rejected", "diverged", "uplink_bits", "t"):
                check(np.array_equal(hg[k], hc[k]),
                      f"mesh {name}: {k} card {hg[k]} cpu {hc[k]}")
            elif k == "arrival_weight":
                check(np.allclose(hg[k], hc[k], rtol=1e-6, atol=0),
                      f"mesh {name}: arrival_weight card {hg[k]} cpu {hc[k]}")
            elif k != "loss":
                gap = float(np.max(np.abs(hg[k] - hc[k]) / np.maximum(np.abs(hc[k]), 1e-30)))
                print(f"mesh {name}: {k} card {hg[k]} (largest relative gap to "
                      f"the CPU {gap:.2e})")
                check(gap <= MESH_PROBE_RTOL, f"mesh {name}: probe {k} differs")
        counters = {k: hg[k].tolist() for k in hg
                    if k in ("n_dropped", "n_rejected", "diverged", "uplink_bits",
                             "arrival_weight")}
        if counters:
            print(f"mesh {name}: {counters} (equal on the CPU)")
        if "n_rejected" in hg:
            check(hg["n_dropped"].tolist() == [0.0, 1.0, 0.0]
                  and hg["n_rejected"].tolist() == [0, 2, 0],
                  f"mesh {name}: the guard's counters are not the script's")
    check(card["hooks"]["stream"][2]["t"].tolist() == list(range(MESH_ROUNDS)),
          "mesh stream: rank 0's shards do not hold the rounds")
    for dev, out in (("card", card), ("CPU", cpu)):
        print(f"mesh hooks on the {dev}: run_mesh_scan bitwise run_mesh_host_loop "
              f"under the guard and the ring on every rank: "
              f"{out['hooks_scan_equals_host_loop']}")
        check(out["hooks_scan_equals_host_loop"],
              f"mesh hooks: the scanned driver differs from its host loop on the {dev}")


def report_mesh_hooks_full(runs: dict, b_total: int, where: str) -> dict[int, int]:
    """13d's checks and numbers: finite losses, the guard's counters
    (round 1: 1 dropped, 2 rejected, none diverged) from rank 0's shards,
    the ring's ``arrival_weight`` against its closed form, the codec's
    measured bits, B1's launches by rank (1, 1 and 4 a round), rank 0's
    round ms and breakdown, every rank's peak.  Returns B1's launches summed
    over the ranks by the rows of its calls."""
    print(f"== phase 13d: bert_100m full width on (data 2, model 2), G = "
          f"{MESH_FULL_CLIENTS} (four clients a client shard), {where} ==")
    calls = {"guard": 1, "ring": 1, "microbatch 1 + int8 codec": MESH_FULL_CLIENTS // 2}
    launches_by_rows = {1: 0, MESH_FULL_CLIENTS // 2: 0}
    peaks = []
    for run, out in runs.items():
        hist = out["hist"]
        check(len(hist["loss"]) == MESH_FULL_ROUNDS and np.isfinite(hist["loss"]).all(),
              f"mesh bert_100m {run}: losses {hist['loss']}")
        for t, (loss, ms) in enumerate(zip(hist["loss"], out["rounds_ms"])):
            print(f"mesh bert_100m {run} round {t}: loss {loss:.5f}  rank 0 ms "
                  f"{ms:.1f}" + ("  (with set-up)" if t == 0 else ""))
        extra = {k: hist[k].tolist() for k in hist if k not in ("loss", "t")}
        print(f"mesh bert_100m {run}: {extra}")
        launches = [int(r[0]) for r in out["ranks"]]
        run_peaks = [r[1] for r in out["ranks"]]
        peaks.append(max(run_peaks))
        print(f"mesh bert_100m {run}: B1 launches by rank {launches} (expect "
              f"{calls[run] * MESH_FULL_ROUNDS} each); peak device memory by rank "
              f"{', '.join(f'{p:.2f}' for p in run_peaks)} GiB (sum {sum(run_peaks):.2f})")
        check(all(n == calls[run] * MESH_FULL_ROUNDS for n in launches),
              f"mesh bert_100m {run}: B1 launches by rank {launches}")
        check(sum(run_peaks) < 75.0,
              f"mesh bert_100m {run}: the ranks' peaks sum to {sum(run_peaks):.1f} GiB")
        rows = 1 if calls[run] > 1 else MESH_FULL_CLIENTS // 2
        launches_by_rows[rows] += sum(launches)
        bd = dict(out["breakdown"])
        total = out["rounds_ms"][-1]
        bd["rest"] = total - sum(bd.values())
        n_coll, coll_ms = out["collectives"]
        print(f"mesh bert_100m {run} round {MESH_FULL_ROUNDS - 1} breakdown on rank 0 "
              f"(ms, round {total:.1f}; each call timed between device "
              f"synchronises): " + ", ".join(
                  f"{k} {v:.1f} ({100 * v / total:.0f}%)" for k, v in bd.items())
              + f"; inside the client step: {n_coll} collective calls, "
              f"{coll_ms:.1f} ms")
        gens = [g for g in out["generations"] if g]
        if gens:
            print(f"mesh bert_100m {run}: derive_generation_params ms by round, "
                  f"one a generation: {[[round(x, 1) for x in g] for g in gens]}")
    guard = runs["guard"]["hist"]
    check(guard["t"].tolist() == list(range(MESH_FULL_ROUNDS)),
          "mesh bert_100m guard: the stream's shards do not hold the rounds")
    check(guard["n_dropped"].tolist() == [0.0, 1.0, 0.0][:MESH_FULL_ROUNDS]
          and guard["n_rejected"].tolist() == [0, 2, 0][:MESH_FULL_ROUNDS]
          and guard["diverged"].tolist() == [0.0, 0.0, 0.0][:MESH_FULL_ROUNDS],
          f"mesh bert_100m guard: counters {guard['n_dropped']}, "
          f"{guard['n_rejected']}, {guard['diverged']}")
    acfg = AsyncConfig(max_delay=2, delay="stagger")
    want = [sum(float(async_module.arrival_weight(acfg, t - d, d, MESH_FULL_CLIENTS,
                                                  "cpu").sum())
                for d in range(acfg.buffer_rounds)) for t in range(MESH_FULL_ROUNDS)]
    got = runs["ring"]["hist"]["arrival_weight"]
    print(f"mesh bert_100m ring: arrival_weight {got.tolist()} (closed form {want})")
    check(np.allclose(got, want, rtol=1e-6), "mesh bert_100m ring: arrival_weight")
    bits = CodecConfig(bits=8, error_feedback=False).payload_bits(b_total) * 2
    got = runs["microbatch 1 + int8 codec"]["hist"]["uplink_bits"]
    print(f"mesh bert_100m codec: uplink_bits {got.tolist()} (payload_bits("
          f"{b_total:,}) x 2 client shards = {bits:,})")
    check((got == bits).all(), "mesh bert_100m codec: uplink_bits")
    print(f"mesh bert_100m hooked runs: the largest rank peak {max(peaks):.2f} GiB")
    return launches_by_rows


# ---------------------------------------------------------------------------
# phase 15: the supervisor over the mesh, and the dry run against the card
# ---------------------------------------------------------------------------

# 15a: a supervised SMOKE run on 13a's ranks, client 1's payload NaN in
# rounds 2 and 3 under the run's original key (a transient fault)
SUP_ROUNDS, SUP_CHUNK = 6, 2
SUP_FAULT_ROUNDS = (2, 4)
# 15c: the dry run's per-rank figures of the two families that exceed one card
DRYRUN_STEP_ARCHS = ("jamba_1_5_large_398b", "deepseek_v3_671b")
DRYRUN_PEAK_FACTOR = 1.5      # the dry run's peak against the card's, either way


class MeshTransient:
    """Client 1's NaN payload in ``SUP_FAULT_ROUNDS``, under the run's
    original key only: any rekeyed retry is clean."""

    def __init__(self, key0, num_clients: int):
        self.key0, self.num_clients = key0, num_clients

    def spec(self, t, base_key, device):
        hit = base_key == self.key0 and SUP_FAULT_ROUNDS[0] <= t < SUP_FAULT_ROUNDS[1]
        codes = [OK] * self.num_clients
        if hit:
            codes[1] = NAN
        return faults_module._spec_from_codes(
            torch.tensor(codes, dtype=torch.int32, device=device), 1e3)


def mesh_supervised(mesh) -> dict:
    """15a on a rank of 13a: ``run_supervised`` over ``run_mesh_scan``
    (bert_100m SMOKE, cross_device, B1 at the uplink on the card), every
    rank on its own shards, B1's count set to 0 just before.  Returns
    every rank's recovery log, the gathered params, the history, every
    rank's B1 launches and the run's seconds on this rank."""
    model, topology = bert_100m.SMOKE, "cross_device"
    cfg = safl_cfg(MESH_SMOKE_SKETCH)
    data = mesh_data(model, False)
    smp = mesh_train.mesh_sampler(mesh, mesh_base_sampler(data), topology)
    _, pspecs = mesh_train._mesh_pspecs(model, topology)
    params = local_shard(mesh, init_params(model, torch.Generator().manual_seed(0),
                                           device=mesh.device), pspecs)
    key = prng.key(0)
    faults = MeshTransient(key, data.num_clients)

    def launch(p, s, *, key, start_round, on_chunk):
        return mesh_train.run_mesh_scan(model, cfg, mesh, smp, p, s, rounds=SUP_ROUNDS,
                                        key=key, topology=topology, chunk_size=SUP_CHUNK,
                                        start_round=start_round, on_chunk=on_chunk,
                                        faults=faults)

    cs.LAUNCHES.n = 0
    t0 = time.perf_counter()
    p, _, hist, log = run_supervised(launch, params, init_safl(cfg, params),
                                     rounds=SUP_ROUNDS, key=key,
                                     config=SupervisorConfig(max_retries=3),
                                     mesh=mesh, pspecs=pspecs)
    launches, seconds = cs.LAUNCHES.n, time.perf_counter() - t0
    logs = [None] * dist.get_world_size()
    dist.all_gather_object(logs, log)
    full = gather_tree(mesh, p, pspecs)
    return {"logs": logs, "params": {k: v.cpu() for k, v in full.items()},
            "hist": hist, "launches": [int(r[0]) for r in _every_rank(mesh, [launches])],
            "seconds": seconds}


def report_mesh_supervised(card: dict, cpu: dict) -> int:
    """15a's checks: the recovery log equal on every rank, card and CPU
    (one rollback to round 2), the final params card against CPU within
    phase 3's tolerance and the d/1000 allowance, B1 once a round run on
    every card rank.  Returns B1's launches summed over the card ranks."""
    print("== phase 15a: the supervisor over the mesh, bert_100m SMOKE, cross_device "
          "(data 2, model 2), a transient NaN payload ==")
    log = card["logs"][0]
    print(f"mesh supervised: {format_recovery_log(log)} ({card['seconds']:.1f} s on "
          f"card rank 0, {cpu['seconds']:.1f} s on CPU rank 0)")
    check(all(l == log for l in card["logs"] + cpu["logs"]),
          f"mesh supervised: the recovery logs differ: card {card['logs']}, "
          f"CPU {cpu['logs']}")
    check(len(log) == 1 and log[0]["t_resume"] == SUP_FAULT_ROUNDS[0],
          f"mesh supervised: expected one rollback to round {SUP_FAULT_ROUNDS[0]}: {log}")
    d = sum(v.numel() for v in cpu["params"].values())
    compare_card_cpu("mesh supervised", (card["params"], None, card["hist"]),
                     (cpu["params"], None, cpu["hist"]), allowed=d // 1000)
    runs = SUP_ROUNDS + SUP_CHUNK * len(log)
    print(f"mesh supervised: B1 launches by card rank {card['launches']} "
          f"({runs} rounds run a rank, the retried ones included)")
    check(card["launches"] == [runs] * len(card["launches"]),
          f"mesh supervised: B1 launches {card['launches']}, not {runs} a rank")
    return sum(card["launches"])


def step_block(model: ModelConfig) -> ModelConfig:
    """``one_block`` behind the leading dense layers: deepseek-v3's three
    dense layers and one MoE block (the layers outside the scan stay)."""
    return dataclasses.replace(one_block(model), num_layers=model.first_dense_layers
                               + len(model.scan_blocks()[1]))


def storage_bytes(*trees) -> int:
    """The bytes of the distinct storages under ``trees`` (nested dicts)."""
    seen, total = set(), 0

    def walk(t):
        nonlocal total
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if st._cdata not in seen:
                seen.add(st._cdata)
                total += st.nbytes()
    for t in trees:
        walk(t)
    return total


def dryrun_host(out_path: str) -> None:
    """15b, 15c, 16c and 17c in a process of their own on the host (no
    card): the dry run (``launch/dryrun.py``: rank 0's step on ``meta``
    shards under a fake process group) of 13b's bert_100m round, 13e's
    dbrx_132b client step, the client step of ``DRYRUN_STEP_ARCHS`` at
    13e's size and 16b's prefill and client step; each one's counts, or the
    port's refusal, and 17a's one-process step (``remat_dry``) into
    ``out_path`` (JSON)."""
    from repro_torch.launch import dryrun
    data = mesh_data(bert_100m.CONFIG, True)
    tokens = lambda shape: {"tokens": torch.empty(shape, dtype=torch.int64, device="meta")}
    step_cfg = dataclasses.replace(safl_cfg(MAIN_SKETCH), local_steps=1)
    cases = [("13b", bert_100m.CONFIG, MESH_GRID, "train",
              tokens((data.num_clients, 2, 8 // 2, data.seq_len)), safl_cfg(MAIN_SKETCH))]
    cases += [(arch, step_block(get_config(arch)), MESH_STEP_GRID, "client",
               tokens((1, 1, 1, MESH_STEP_TOKENS)), step_cfg)
              for arch in MESH_STEP_ARCHS[:1] + DRYRUN_STEP_ARCHS]
    cases += [("16b prefill", part_full_model32(), PART_FULL_GRID, "prefill",
               tokens(PART_FULL_PREFILL), None),
              ("16b client", step_block(get_config(PART_FULL_ARCH)), PART_FULL_GRID,
               "client", tokens((1, 1, 1, MESH_STEP_TOKENS)), step_cfg)]
    out = {"17a": remat_dry()}
    for name, model, (sizes, axes), kind, batch, cfg in cases:
        t0 = time.perf_counter()
        try:
            run = dryrun.dry_run(model, sizes, axes, {"batch": batch}, kind=kind,
                                 safl=cfg)
            out[name] = {"status": "ok", "counts": run["counts"]}
        except ValueError as e:
            out[name] = {"status": f"refused: {e}"}
        out[name]["seconds"] = time.perf_counter() - t0
    with open(out_path, "w") as f:
        json.dump(out, f)


def start_dryrun_host(out_path: str) -> subprocess.Popen:
    """``dryrun_host`` in a background process on the host, with no card
    visible to it, at a lower priority than the card's phases; its output
    goes to ``out_path + ".log"``."""
    here = str(Path(__file__).resolve().parent)
    code = (f"import os, sys; os.nice(5); sys.path.insert(0, {here!r}); "
            f"import chip_smoke; chip_smoke.dryrun_host({out_path!r})")
    with open(out_path + ".log", "w") as log:
        return subprocess.Popen([sys.executable, "-c", code],
                                env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                                stdout=log, stderr=subprocess.STDOUT)


def report_dryrun(proc: subprocess.Popen, out_path: str, measured: dict) -> dict:
    """15b and 15c: the dry run's rank-0 argument bytes against the card
    ranks' live shards in 13b and 13e (exactly), its peak against the
    card's ``max_memory_allocated`` (within ``DRYRUN_PEAK_FACTOR``), 13e's
    achieved TFLOP/s from its counted FLOPs, and the per-rank figures of
    ``DRYRUN_STEP_ARCHS``.  Returns every case's result (16c reads its own)."""
    t0 = time.perf_counter()
    proc.wait(timeout=600)
    check(proc.returncode == 0,
          f"the dry run failed:\n{Path(out_path + '.log').read_text()[-3000:]}")
    with open(out_path) as f:
        got = json.load(f)
    print(f"== phase 15b: the dry run (meta shards, a fake process group, on the "
          f"host beside the card's phases; waited {time.perf_counter() - t0:.1f} s "
          f"for it) against the card ==")
    for name, what in (("13b", "bert_100m round on (data 2, model 2)"),
                       ("dbrx_132b", "dbrx_132b client step, one block, (data 1, model 4)")):
        r, m = got[name], measured[name]
        check(r["status"] == "ok", f"dry run {name}: {r['status']}")
        c = r["counts"]
        mem = c["memory"]
        ratio = mem["peak_bytes"] / m["peak_bytes"]
        print(f"dry run {what}: {r['seconds']:.1f} s to trace; rank 0 arguments "
              f"{mem['argument_bytes']:,} B (the card rank's live shards "
              f"{m['argument_bytes']:,} B); peak {mem['peak_bytes'] / 2**30:.2f} GiB "
              f"against the card's {m['peak_bytes'] / 2**30:.2f} GiB (ratio "
              f"{ratio:.3f}); {c['flops']:.4e} FLOPs, collectives "
              f"{c['collective_calls']} ({sum(c['collective_bytes'].values()):,} B), "
              f"kernels {c['kernels']}")
        if name == "13b":
            check(c["kernels"].get("countsketch_clients", {}).get("launches") == 1,
                  f"dry run 13b: B1's meta route {c['kernels']}, not one launch")
            # the workspace the meta route holds is the source's layout
            n, b = 66_046_464, 1_321_033
            width, large = cs.route(n, b)
            ints = (cs._fn("cs_work_ints")(n, -(-b // width), int(large)),
                    cs.work_ints(n, -(-b // width), large))
            print(f"B1's workspace at the mesh uplink: {ints[0]:,} int32 (the meta "
                  f"route's model {ints[1]:,})")
            check(ints[0] == ints[1], f"B1's workspace model {ints}")
        check(mem["argument_bytes"] == m["argument_bytes"],
              f"dry run {name}: argument bytes {mem['argument_bytes']} against "
              f"{m['argument_bytes']}")
        check(1 / DRYRUN_PEAK_FACTOR <= ratio <= DRYRUN_PEAK_FACTOR,
              f"dry run {name}: peak ratio {ratio:.3f} outside {DRYRUN_PEAK_FACTOR}x")
    c, ms = got["dbrx_132b"]["counts"], measured["dbrx_132b"]["step_ms"]
    print(f"13e dbrx_132b: {c['flops']:.4e} FLOPs counted on rank 0 in "
          f"{ms:.1f} ms: {c['flops'] / ms / 1e9:.2f} TFLOP/s achieved (of the "
          f"card's 989 bf16 dense, four ranks sharing it)")
    print("== phase 15c: the dry run of the client step that exceeds one card, one "
          f"block at full width, {MESH_STEP_TOKENS} tokens, bf16, on "
          f"{dict(zip(MESH_STEP_GRID[1], MESH_STEP_GRID[0]))} (no card) ==")
    for arch in DRYRUN_STEP_ARCHS:
        r = got[arch]
        if r["status"] != "ok":
            print(f"{arch}: {r['status']} ({r['seconds']:.1f} s)")
            continue
        mem = r["counts"]["memory"]
        print(f"{arch}: ok; per rank: arguments {mem['argument_bytes'] / 2**30:.2f} GiB, "
              f"outputs {mem['output_bytes'] / 2**30:.2f}, temporaries "
              f"{mem['temp_bytes'] / 2**30:.2f}, peak {mem['peak_bytes'] / 2**30:.2f} "
              f"GiB; {r['counts']['flops']:.4e} FLOPs, collectives "
              f"{r['counts']['collective_calls']} ({r['seconds']:.1f} s to trace)")
    return got


# ---------------------------------------------------------------------------
# phase 16: whole heads on a model axis that cuts them (ROADMAP A-15)
# ---------------------------------------------------------------------------

# 16a, on 13e's (data 1, model 4) ranks: (name, arch, SMOKE overrides).  The
# first two split their 2 key/value heads over 4 ranks, the variants their
# 6 query heads too (qwen2-7b with its q/k/v biases; whisper's encoder and
# cross-attention)
PART_SMOKE_CASES = (("llama3_2_1b", "llama3_2_1b", {}),
                    ("h2o_danube_1_8b", "h2o_danube_1_8b", {}),
                    ("qwen2_7b 6/2 heads", "qwen2_7b",
                     dict(num_heads=6, num_kv_heads=2, head_dim=32)),
                    ("whisper_large_v3 6/6 heads", "whisper_large_v3",
                     dict(num_heads=6, num_kv_heads=6, head_dim=32)))
PART_SMOKE_B, PART_SMOKE_S = 4, 16      # 16a's prefill batch, and its client's
# 16a's client step: the delta's largest gap over the reference's largest
# entry, besides phase 3's tolerance (float32 sums in another order: ~1e-6)
PART_REL_TOL = 1e-4
# 16b: qwen2-7b at full width, one block; over 8 ranks a rank holds 3.5 of
# its 28 query heads and half of one of its 4 key/value heads
PART_FULL_GRID = ((1, 8), ("data", "model"))
PART_FULL_ARCH = "qwen2_7b"
PART_FULL_PREFILL = (2, 512)            # float32 prefill: B x tokens


def part_heads_smoke(mesh) -> dict:
    """16a on a rank of 13e's (data 1, model 4) ranks: each case's prefill
    in the default and FSDP layouts and one client step
    (``client_deltas_sharded``, K = 1) on the rank's shards, against the
    one-process ``make_prefill_step`` and ``client_delta`` this rank runs
    on its device from the same weights.  The kernels' launch counts are
    set to 0 before and summed over the ranks after."""
    dev = mesh.device
    for c in kernel_counts():
        c.n = 0
    t0 = time.perf_counter()
    cfg = dataclasses.replace(safl_cfg(MAIN_SKETCH), local_steps=1)
    eta = safl_module._f32(cfg.client_lr)
    out = {}
    for name, arch, over in PART_SMOKE_CASES:
        model = dataclasses.replace(get_config(arch, smoke=True), **over)
        params = init_params(model, torch.Generator().manual_seed(0), device=dev)
        batch = zoo_batch(model, PART_SMOKE_B, PART_SMOKE_S, dev, model.dtype)
        bspecs = mesh_train.infer_batch_pspecs(batch, mesh_train.data_axes_of(mesh), mesh)
        want = mesh_train.make_prefill_step(model)(params, batch)
        cut = local_shard(mesh, {"l": want}, {"l": (bspecs["tokens"][0], "model")})["l"]
        res = {}
        for fsdp in (False, True):
            step = mesh_train.make_prefill_step(model, mesh, fsdp=fsdp, batch=PART_SMOKE_B)
            blk = step(local_shard(mesh, params, step.par.pspecs),
                       local_shard(mesh, batch, bspecs))
            err, n = outside_tol(blk, cut)
            every = _every_rank(mesh, [err, n, float(blk.shape == cut.shape)])
            res["prefill " + ("fsdp" if fsdp else "default")] = (
                max(r[0] for r in every), int(sum(r[1] for r in every)),
                all(r[2] == 1.0 for r in every))
        delta, loss = safl_module.client_delta(
            cfg, lambda p, b: loss_fn(model, p, b), params,
            {k: v[None] for k, v in batch.items()}, eta)
        _, pspecs = mesh_train._mesh_pspecs(model, "cross_device")
        deltas, losses = mesh_train.client_deltas_sharded(
            model, cfg, mesh, "cross_device", local_shard(mesh, params, pspecs),
            {k: v[None, None] for k, v in batch.items()}, eta, pspecs)
        ref = local_shard(mesh, delta, pspecs)
        errs = [outside_tol(deltas[k][0], ref[k]) for k in pspecs]
        top = max(float(v.abs().max()) for v in ref.values())
        every = _every_rank(mesh, [max(e for e, _ in errs), sum(n for _, n in errs), top])
        worst = max(r[0] for r in every)
        res["client step"] = (worst, int(sum(r[1] for r in every)),
                              worst <= PART_REL_TOL * max(r[2] for r in every)
                              and abs(float(losses[0]) - float(loss))
                              <= 1e-5 * abs(float(loss)))
        out[name] = res
    launches = sum(c.n for c in kernel_counts())
    return {"cases": out, "seconds": time.perf_counter() - t0,
            "launches": [int(r[0]) for r in _every_rank(mesh, [launches])]}


def part_full_batch(model: ModelConfig, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(16)
    return {"tokens": torch.randint(0, model.vocab_size, PART_FULL_PREFILL,
                                    generator=gen, device=device)}


def part_full_model32() -> ModelConfig:
    return dataclasses.replace(one_block(get_config(PART_FULL_ARCH)), dtype=torch.float32)


def part_heads_full_rank(mesh, ref_dir: str) -> dict:
    """16b on a rank of (data 1, model 8): the float32 prefill on the
    rank's blocks (drawn leaf by leaf), once to warm up and once timed with
    its collectives, its (B, V_loc) block against the one-process logits
    (``ref_dir/logits.pt``); then 13e's bf16 client step
    (``mesh_step_rank``, its references under ``ref_dir/<arch>``).  The
    kernels' launch counts are set to 0 before and summed after."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.device
    for c in kernel_counts():
        c.n = 0
    model = part_full_model32()
    step = mesh_train.make_prefill_step(model, mesh, fsdp=False, batch=PART_FULL_PREFILL[0])
    lp = shard_init(mesh, model, step.par.pspecs, dev)
    batch = part_full_batch(model, dev)
    rows = local_shard(mesh, batch, mesh_train.infer_batch_pspecs(
        batch, mesh_train.data_axes_of(mesh), mesh))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    args = storage_bytes(lp, rows)
    step(lp, rows)
    clock = CollectiveClock(dev)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with clock:
        blk = step(lp, rows)
        torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) * 1e3
    peak_bytes = torch.cuda.max_memory_allocated(dev)
    want = torch.load(os.path.join(ref_dir, "logits.pt"))
    cut = local_shard(mesh, {"l": want}, {"l": (None, "model")})["l"].to(dev)
    err, n = outside_tol(blk, cut)
    every = _every_rank(mesh, [err, n, peak_bytes / 2**30])
    del lp, rows, blk
    torch.cuda.empty_cache()
    out = {"prefill": {"ms": ms, "collectives": (clock.calls, clock.seconds * 1e3),
                       "max_abs_err": max(r[0] for r in every),
                       "outside": int(sum(r[1] for r in every)),
                       "peaks": [r[2] for r in every], "argument_bytes": args,
                       "peak_bytes": peak_bytes},
           "step": mesh_step_rank(mesh, PART_FULL_ARCH,
                                  os.path.join(ref_dir, PART_FULL_ARCH))}
    launches = sum(c.n for c in kernel_counts())
    out["launches"] = [int(r[0]) for r in _every_rank(mesh, [launches])]
    return out


def part_full_references(ref_dir: str) -> dict:
    """16b's one-process references on the card: the float32 prefill's
    logits (saved as ``ref_dir/logits.pt``) and 13e's bf16 client step
    (``mesh_step_reference``), after checking that every leaf divides
    over ``PART_FULL_GRID``."""
    layout = Mesh(*PART_FULL_GRID)
    model = part_full_model32()
    pspecs = mesh_train._mesh_pspecs(model, "cross_device")[1]
    for k, shape in param_shapes(model).items():     # raises where a dim does not divide
        sharding._block(layout, shape, pspecs[k], 0)
    params = init_params(model, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    batch = part_full_batch(model, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = mesh_train.make_prefill_step(model)(params, batch)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    torch.save(logits.cpu(), os.path.join(ref_dir, "logits.pt"))
    del params, logits
    torch.cuda.empty_cache()
    ref = mesh_step_reference(PART_FULL_ARCH, os.path.join(ref_dir, PART_FULL_ARCH))
    ref["prefill_ms"] = prefill_ms
    return ref


def phase_part_heads(smoke: dict, dry: dict) -> None:
    """Phase 16: (a) 16a's report (run inside phase 13's card ranks,
    ``part_heads_smoke``); (b) qwen2-7b at full width, one block, on
    (data 1, model 8), eight ranks sharing the card through gloo, against
    the one-process steps; (c) the dry run of (b)'s two steps (run on the
    host with 15b's) against the card rank's argument bytes and peak; (d)
    the kernels' launches on this path."""
    grid = dict(zip(MESH_STEP_GRID[1], MESH_STEP_GRID[0]))
    print(f"== phase 16a: SMOKE archs whose heads {grid} splits, prefill (default, "
          f"FSDP) and one client step against one process on the card ==")
    for name, res in smoke["cases"].items():
        print(f"{name}: " + "; ".join(f"{k} max abs diff {v[0]:.3e}, outside {v[1]}"
                                     for k, v in res.items()))
        for k, v in res.items():
            check(v[1] == 0 and v[2], f"16a {name} {k}: differs from the one-process step")
    print(f"16a: {smoke['seconds']:.1f} s on rank 0 (inside phase 13's card ranks)")
    world = math.prod(PART_FULL_GRID[0])
    where = ("sharing the card (gloo)" if choose_backend(world, "cuda") == "gloo"
             else "a card each (NCCL)")
    fgrid = dict(zip(PART_FULL_GRID[1], PART_FULL_GRID[0]))
    cfg = get_config(PART_FULL_ARCH)
    print(f"== phase 16b: {PART_FULL_ARCH} at full width ({cfg.num_heads} query, "
          f"{cfg.num_kv_heads} key/value heads), one block, on {fgrid}, {world} ranks "
          f"{where} ==")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="part_heads_") as tmp:
        ref = part_full_references(tmp)
        t1 = time.perf_counter()
        got = spawn(part_heads_full_rank, *PART_FULL_GRID, tmp, device="cuda", timeout=600)
    t2 = time.perf_counter()
    pf = got["prefill"]
    calls, coll_ms = pf["collectives"]
    B, S = PART_FULL_PREFILL
    print(f"{PART_FULL_ARCH} float32 prefill, {B} x {S} tokens: {pf['ms']:.1f} ms on rank 0 "
          f"after a warm-up ({calls} collective calls, {coll_ms:.1f} ms inside them; one "
          f"process {ref['prefill_ms']:.1f} ms with its first call), logits max abs diff "
          f"{pf['max_abs_err']:.3e}, outside phase 3's tolerance {pf['outside']}; peaks "
          f"by rank {', '.join(f'{p:.2f}' for p in pf['peaks'])} GiB")
    check(pf["outside"] == 0, f"16b: the sharded prefill differs from the one-process logits")
    check_client_step(PART_FULL_ARCH, ref, got["step"])
    print(f"16b: references {t1 - t0:.1f} s, {world} ranks {t2 - t1:.1f} s")
    print("== phase 16c: the dry run of 16b (rank 0, meta shards, a fake process group, "
          "on the host) against the card ==")
    for name, m in (("16b prefill", pf), ("16b client", got["step"])):
        r = dry[name]
        check(r["status"] == "ok", f"dry run {name}: {r['status']}")
        mem, c = r["counts"]["memory"], r["counts"]
        ratio = mem["peak_bytes"] / m["peak_bytes"]
        print(f"dry run {name}: {r['seconds']:.1f} s to trace; rank 0 arguments "
              f"{mem['argument_bytes']:,} B (the card rank's live shards "
              f"{m['argument_bytes']:,} B); peak {mem['peak_bytes'] / 2**30:.2f} GiB "
              f"against the card's {m['peak_bytes'] / 2**30:.2f} GiB (ratio {ratio:.3f}); "
              f"{c['flops']:.4e} FLOPs, collectives {c['collective_calls']}")
        check(mem["argument_bytes"] == m["argument_bytes"],
              f"dry run {name}: argument bytes {mem['argument_bytes']} against "
              f"{m['argument_bytes']}")
    launches = sum(smoke["launches"]) + sum(got["launches"])
    print(f"== phase 16d: the part-head path launched {launches} of the TPU kernels' "
          f"counterparts (16a by rank {smoke['launches']}, 16b {got['launches']}; it "
          f"reaches none, as in the reference) ==")
    print(f"phase 16 {time.perf_counter() - t0:.1f} s on the host beside 16a")


# ---------------------------------------------------------------------------
# phase 17: rematerialization, each block recomputed in the backward (A-16)
# ---------------------------------------------------------------------------

REMAT_MODEL = llama3_2_1b.CONFIG        # published width, all 16 blocks, bf16
REMAT_TOKENS = 4096                     # 17a: train_4k's sequence, one client
REMAT_PAIR_TOKENS = 1024                # 17b: with remat against without
REMAT_MIN_COS = 0.99999                 # 17b: the delta's cosine across the pair
REMAT_CFG = SAFLConfig(client_lr=0.01, local_steps=1)
REMAT_TURNS = (False, True, True, False) * 2   # 17b's timed runs, in turns


def remat_batch(S: int, device="cuda") -> dict:
    """One client's one local step of one S-token sequence: (K, B, S) = (1, 1, S)."""
    if device == "meta":
        return {"tokens": torch.empty((1, 1, S), dtype=torch.int64, device="meta")}
    gen = torch.Generator(device=device).manual_seed(7)
    return {"tokens": torch.randint(0, REMAT_MODEL.vocab_size, (1, 1, S), generator=gen,
                                    device=device)}


def remat_step(params: dict, mb: dict, remat: bool):
    """``client_delta`` (K = 1) of ``REMAT_MODEL``: (the float32 delta, the loss)."""
    return safl_module.client_delta(
        REMAT_CFG, lambda p, b: loss_fn(REMAT_MODEL, p, b, remat=remat), params, mb,
        safl_module._f32(REMAT_CFG.client_lr))


def remat_grad(params: dict, mb: dict, remat: bool):
    """The step's loss and gradients alone (before the update and the delta)."""
    leaves = [p.detach().requires_grad_(True) for p in params.values()]
    loss = loss_fn(REMAT_MODEL, dict(zip(params, leaves)), {"tokens": mb["tokens"][0]},
                   remat=remat)
    return torch.autograd.grad(loss, leaves)


def remat_dry() -> dict:
    """17c on the host: ``OpCosts`` of 17a's step and of its gradient alone on
    ``meta`` tensors (no process group), with and without remat."""
    from repro_torch.launch.op_costs import OpCosts
    out = {}
    for remat in (True, False):
        for what, fn in (("step", remat_step), ("grad", remat_grad)):
            params = {k: torch.empty(s, dtype=REMAT_MODEL.dtype, device="meta")
                      for k, s in param_shapes(REMAT_MODEL).items()}
            mb = remat_batch(REMAT_TOKENS, "meta")
            t0 = time.perf_counter()
            with OpCosts((params, mb)) as oc:
                oc.set_outputs(fn(params, mb, remat))
            out[f"{what} {'remat' if remat else 'no remat'}"] = {
                "counts": oc.counts(), "seconds": time.perf_counter() - t0}
    return out


def timed_peak(fn):
    """(fn(), its ms between CUDA events, the peak GiB while it ran)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop), peak_gib()


def tree_cosine(a: dict, b: dict) -> float:
    dot = na = nb = 0.0
    for k, x in a.items():
        x, y = x.double(), b[k].double()
        dot, na, nb = dot + float((x * y).sum()), na + float((x * x).sum()), \
            nb + float((y * y).sum())
    return dot / math.sqrt(na * nb)


def phase_remat(dry: dict) -> None:
    """Phase 17: (a) llama3.2-1b at its published width and all 16 blocks,
    bf16: one client's local step (``client_delta``, K = 1) of one
    4,096-token sequence with the blocks recomputed (remat, the default),
    its loss, ms and peak, and its gradient's peak alone; (b) the same step
    at 1,024 tokens with and without remat: the loss bit for bit, the
    delta's cosine, both peaks and the time ratio (timed in turns); (c)
    the host's dry run of (a) on ``meta`` (``remat_dry``) against the
    card's peaks, and the figure without remat, which (a) does not run.
    No TPU kernel is on this path: the launches are printed."""
    counts = kernel_counts()
    for c in counts:
        c.n = 0
    t0 = time.perf_counter()
    model = REMAT_MODEL
    print(f"== phase 17a: {model.name} at full width ({model.num_layers} blocks, "
          f"{model.dtype}), one client's local step of one {REMAT_TOKENS:,}-token "
          f"sequence, each block recomputed in the backward ==")
    params = init_params(model, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    d = sum(p.numel() for p in params.values())
    mb = remat_batch(REMAT_TOKENS)
    remat_step(params, mb, True)                            # warm-up
    (delta, loss), ms, peak = timed_peak(lambda: remat_step(params, mb, True))
    finite = all(bool(torch.isfinite(v).all()) for v in delta.values())
    shapes = all(delta[k].shape == p.shape for k, p in params.items())
    del delta
    grads, grad_ms, grad_peak = timed_peak(lambda: remat_grad(params, mb, True))
    del grads                                   # not held through 17b
    flops = dry["step remat"]["counts"]["flops"]
    print(f"17a: d = {d:,}; loss {float(loss):.5f}; the step {ms:.1f} ms after a warm-up "
          f"(CUDA events; {flops / ms / 1e9:.1f} TFLOP/s of its {flops:.4e} counted "
          f"FLOPs), peak {peak:.2f} GiB; the gradient alone {grad_ms:.1f} ms, peak "
          f"{grad_peak:.2f} GiB")
    check(math.isfinite(float(loss)) and finite and shapes,
          f"17a: loss {float(loss)}, delta finite {finite}, shapes {shapes}")
    print(f"== phase 17b: the same step at {REMAT_PAIR_TOKENS:,} tokens, with remat "
          f"against without ==")
    mb = remat_batch(REMAT_PAIR_TOKENS)
    out = {r: remat_step(params, mb, r) for r in (False, True)}
    (d0, l0), (d1, l1) = out[False], out[True]
    cos = tree_cosine(d1, d0)
    diff = max(float((d1[k] - d0[k]).abs().max()) for k in d0)
    same = torch.equal(l0, l1)
    del out, d0, d1
    times, peaks, grad_peaks = {False: [], True: []}, {}, {}
    for r in REMAT_TURNS:
        out, t, pk = timed_peak(lambda: remat_step(params, mb, r))
        del out                                 # not held through the next run
        times[r].append(t)
        peaks[r] = max(peaks.get(r, 0.0), pk)
    for r in (False, True):
        grad_peaks[r] = timed_peak(lambda: remat_grad(params, mb, r))[2]
    ms0, ms1 = statistics.median(times[False]), statistics.median(times[True])
    print(f"17b: loss {float(l1):.6f} with remat, {float(l0):.6f} without (bit for bit: "
          f"{same}); delta cosine {cos:.7f}, max abs diff {diff:.3e}; the step "
          f"{ms1:.1f} ms with remat, {ms0:.1f} without (medians of {len(times[True])} "
          f"runs each, in turns; ratio {ms1 / ms0:.3f}; the runs "
          f"{[round(t, 1) for t in times[True]]} and "
          f"{[round(t, 1) for t in times[False]]}); peaks {peaks[True]:.2f} and "
          f"{peaks[False]:.2f} GiB, the gradient alone {grad_peaks[True]:.2f} and "
          f"{grad_peaks[False]:.2f} GiB")
    check(same, f"17b: the loss differs with remat: {float(l1)!r} against {float(l0)!r}")
    check(cos >= REMAT_MIN_COS, f"17b: delta cosine {cos} below {REMAT_MIN_COS}")
    del params
    torch.cuda.empty_cache()
    print(f"== phase 17c: the dry run of 17a ({model.name}, {REMAT_TOKENS:,} tokens, "
          f"one process, meta tensors on the host) against the card ==")
    for what, card in (("step", peak), ("grad", grad_peak)):
        r = dry[f"{what} remat"]
        mem = r["counts"]["memory"]
        ratio = mem["peak_bytes"] / 2**30 / card
        print(f"dry run 17a {what}: {r['seconds']:.1f} s to trace; arguments "
              f"{mem['argument_bytes'] / 2**30:.2f} GiB, outputs "
              f"{mem['output_bytes'] / 2**30:.2f}, temporaries "
              f"{mem['temp_bytes'] / 2**30:.2f}, peak {mem['peak_bytes'] / 2**30:.2f} GiB "
              f"against the card's {card:.2f} (ratio {ratio:.3f})")
        check(1 / DRYRUN_PEAK_FACTOR <= ratio <= DRYRUN_PEAK_FACTOR,
              f"dry run 17a {what}: peak ratio {ratio:.3f} outside {DRYRUN_PEAK_FACTOR}x")
        mem0 = dry[f"{what} no remat"]["counts"]["memory"]
        print(f"dry run 17a {what} without remat (not run on the card): peak "
              f"{mem0['peak_bytes'] / 2**30:.2f} GiB, temporaries "
              f"{mem0['temp_bytes'] / 2**30:.2f}; FLOPs "
              f"{dry[f'{what} no remat']['counts']['flops']:.4e} against "
              f"{r['counts']['flops']:.4e} with remat")
    print(f"phase 17: {time.perf_counter() - t0:.1f} s; the remat path launched "
          f"{sum(c.n for c in counts)} of the TPU kernels' counterparts (it reaches "
          f"none, as in the reference)")


def print_cs_launches(name: str, n: dict[str, int]) -> None:
    print(f"{name}: countsketch route called {n['countsketch']} times, "
          f"{n['countsketch_device']} device launches (kernels and memsets), "
          f"{n['countsketch_device'] / n['countsketch']:.1f} per call")


class Laps:
    """Each phase's seconds: ``lap(name)`` prints the time since the last
    lap, ``summary()`` every lap and the total."""

    def __init__(self):
        self.t0 = self.t = time.perf_counter()
        self.laps = []

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self.laps.append((name, now - self.t))
        print(f"[{name}: {now - self.t:.1f} s]")
        self.t = now

    def summary(self) -> str:
        return ("phase seconds: " + ", ".join(f"{n} {s:.1f}" for n, s in self.laps)
                + f"; total {time.perf_counter() - self.t0:.1f}")


def main() -> int:
    laps = Laps()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    print("== phase 1: card and setup ==")
    print(smi_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    reports = build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s: "
          f"{sorted(reports)}")
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  [{name}] {line.strip()}")

    laps.lap("1")
    dry_dir = tempfile.TemporaryDirectory(prefix="dryrun_")
    dry_out = os.path.join(dry_dir.name, "dryrun.json")
    dry = start_dryrun_host(dry_out)
    try:
        return run_phases(laps, dry, dry_out)
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.wait()
        dry_dir.cleanup()


def run_phases(laps: Laps, dry: subprocess.Popen, dry_out: str) -> int:
    """Phases 2 to 16 (the dry run ``dry`` started in the background) and
    the closing lines."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    entries = phase_kernels(gen)
    torch.cuda.empty_cache()
    entries += phase_gaussian(gen)
    torch.cuda.empty_cache()
    laps.lap("2")
    phase_card_vs_cpu()
    laps.lap("3")

    print("== phase 4: main path, bert_100m full width, count-sketch ==")
    by_name = {e["name"]: e for e in entries}
    n, peak4 = phase_full("bert_100m", bert_100m.CONFIG, MAIN_SKETCH,
                          {"countsketch": cs.LAUNCHES,
                           "countsketch_device": cs.DEVICE_LAUNCHES})
    print_cs_launches("bert_100m", n)
    by_name["countsketch_clients"]["launches"] = n["countsketch"]
    torch.cuda.empty_cache()
    laps.lap("4")
    print("== phase 5: lm25m, SRHT ==")
    n, _ = phase_full("lm25m", LM25M, SRHT_SKETCH,
                      {"countsketch": cs.LAUNCHES, "fwht": fw.LAUNCHES,
                       "countsketch_device": cs.DEVICE_LAUNCHES,
                       "fwht_device": fw.DEVICE_LAUNCHES})
    print_cs_launches("lm25m", n)
    by_name["countsketch"]["launches"] = n["countsketch"]
    by_name["fwht_rows"]["launches"] = n["fwht"]
    torch.cuda.empty_cache()
    laps.lap("5")
    n = phase_noniid()
    print_cs_launches("bert_100m sacfl", n)
    by_name["countsketch_clients"]["launches"] += n["countsketch"]
    torch.cuda.empty_cache()
    laps.lap("6")
    phase_resume()
    laps.lap("7")
    phase_baselines_smoke()
    torch.cuda.empty_cache()
    n = phase_baselines_full()
    print_cs_launches("bert_100m fetchsgd", n)
    by_name["countsketch_clients"]["launches"] += n["countsketch_uplink"]
    by_name["countsketch_resketch"]["launches"] = n["countsketch_resketch"]
    torch.cuda.empty_cache()
    laps.lap("8")
    t9 = time.perf_counter()
    phase_hooks_smoke()
    torch.cuda.empty_cache()
    by_name["countsketch_chunk"]["launches"] = phase_streamed_full(peak4)
    torch.cuda.empty_cache()
    phase_async_full(peak4)
    torch.cuda.empty_cache()
    phase_stream_workload()
    print(f"phase 9: {time.perf_counter() - t9:.1f} s")
    laps.lap("9")
    torch.cuda.empty_cache()
    t10 = time.perf_counter()
    phase_telemetry_smoke()
    torch.cuda.empty_cache()
    by_name["countsketch_clients"]["launches"] += phase_supervised_full(peak4)
    torch.cuda.empty_cache()
    phase_launchers()
    print(f"phase 10: {time.perf_counter() - t10:.1f} s")
    laps.lap("10")
    torch.cuda.empty_cache()
    t11 = time.perf_counter()
    phase_intrinsic_dim()
    torch.cuda.empty_cache()
    for name, calls in phase_zoo_rounds().items():
        by_name[name]["launches"] = calls
    phase_zoo_steps()
    print(f"phase 11: {time.perf_counter() - t11:.1f} s")
    laps.lap("11")
    torch.cuda.empty_cache()
    t12 = time.perf_counter()
    counts = kernel_counts()
    for c in counts:
        c.n = 0
    phase_serve_full()
    phase_decode_families()
    phase_decode_smoke()
    print(f"phase 12: {time.perf_counter() - t12:.1f} s; the decode path launched "
          f"{sum(c.n for c in counts)} of the TPU kernels' counterparts (it reaches "
          f"none, as in the reference)")
    laps.lap("12")
    torch.cuda.empty_cache()
    calls_by_name, measured = phase_mesh()
    for name, calls in calls_by_name.items():
        by_name[name]["launches"] = calls
    laps.lap("13")
    torch.cuda.empty_cache()
    phase_serve_mesh()
    laps.lap("14")
    dry_got = report_dryrun(dry, dry_out, measured)
    laps.lap("15")
    torch.cuda.empty_cache()
    phase_part_heads(measured["part_smoke"], dry_got)
    laps.lap("16")
    torch.cuda.empty_cache()
    phase_remat(dry_got["17a"])
    laps.lap("17")
    for e in entries:
        check(e["launches"] > 0, f"{e['name']} never launched on its path")
        check(set(e) == KERNEL_KEYS, f"{e['name']}: keys {sorted(e)}")

    print(laps.summary())
    print(json.dumps({"kernels": entries}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
