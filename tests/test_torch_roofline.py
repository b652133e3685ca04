"""The port's roofline terms (``repro_torch.launch.roofline``) against the
reference's (``repro.launch.roofline``), on the CPU.

* ``model_flops_for``, ``analytic_memory_bytes`` and ``decode_cache_bytes``
  equal the reference's to float64 rel 1e-12 for all twelve configs at
  full width, every eligible shape of ``INPUT_SHAPES`` (one case a shape
  kind), chips 256 and 512, moment bytes 2 and 4, local steps 1 and 2.
* ``analyze`` on hand-built counts gives the formula's three terms
  against the H100's data-sheet constants, ``dominant`` and
  ``useful_flops_ratio``; ``RooflineReport`` has the reference's fields
  and ``format_row`` prints the reference's row.
* ``launch/dryrun.py``'s ``build_safl_cfg`` and ``topology_for`` pick the
  reference's topology, moment dtype and sketch for every config.  The
  reference's dryrun module sets its 512-device flag on import, so it runs
  in a subprocess.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro.configs import ARCHS
from repro.configs import INPUT_SHAPES as R_SHAPES
from repro.configs import get_config as r_config
from repro.configs import shape_eligible as r_eligible
from repro.launch import roofline as R
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as RL

from torch_priority import lower_priority  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
REL = 1e-12


def _close(got: float, want: float, what) -> None:
    assert abs(got - want) <= REL * max(abs(want), 1.0), (what, got, want)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_analytic_terms_match_reference(kind):
    n = 0
    for arch in ARCHS:
        rcfg, tcfg = r_config(arch), get_config(arch)
        for name, sh in INPUT_SHAPES.items():
            if sh.kind != kind or not r_eligible(rcfg, name)[0]:
                continue
            rsh = R_SHAPES[name]
            _close(RL.decode_cache_bytes(tcfg, sh), R.decode_cache_bytes(rcfg, rsh),
                   (arch, name))
            for k in (1, 2):
                _close(RL.model_flops_for(tcfg, sh, local_steps=k),
                       R.model_flops_for(rcfg, rsh, local_steps=k), (arch, name, k))
                for chips in (256, 512):
                    for mb in (2, 4):
                        _close(RL.analytic_memory_bytes(tcfg, sh, chips, moment_bytes=mb,
                                                        local_steps=k),
                               R.analytic_memory_bytes(rcfg, rsh, chips, moment_bytes=mb,
                                                       local_steps=k),
                               (arch, name, k, chips, mb))
                        n += 1
    assert n >= 12 * 2 * 2 * 2


COUNTS = {
    "compute": dict(flops=2e15, coll=1e6, mem=1e9),
    "memory": dict(flops=1e9, coll=1e6, mem=1e12),
    "collective": dict(flops=1e9, coll=1e12, mem=1e9),
}


@pytest.mark.parametrize("dom", list(COUNTS))
def test_analyze_on_hand_built_counts(dom):
    c = COUNTS[dom]
    counts = {"flops": c["flops"],
              "collective_calls": {"all_reduce": 3, "all_gather": 1},
              "collective_bytes": {"all_reduce": c["coll"] * 0.75,
                                   "all_gather": c["coll"] * 0.25},
              "kernels": {"countsketch_clients": {"launches": 1, "bytes": 4096.0}},
              "memory": {"argument_bytes": 100, "output_bytes": 20,
                         "temp_bytes": 30, "peak_bytes": 140}}
    rep = RL.analyze(counts, arch="a", shape="s", mesh_name="16x16", chips=256,
                     model_flops=1e17, analytic_mem_bytes=c["mem"])
    assert rep.compute_s == c["flops"] / 989e12
    assert rep.memory_s == c["mem"] / 3.35e12
    assert rep.collective_s == c["coll"] / 450e9
    assert rep.dominant == dom
    assert rep.useful_flops_ratio == 1e17 / (c["flops"] * 256)
    assert rep.coll_breakdown["total"] == c["coll"]
    assert rep.coll_breakdown["counts"] == {"all_reduce": 3, "all_gather": 1}
    assert rep.bytes_per_device_hbm == 150.0
    assert "countsketch_clients:1x" in rep.note
    assert json.loads(json.dumps(rep.to_json()))["dominant"] == dom


def test_report_fields_and_row_match_reference():
    fields = [f.name for f in dataclasses.fields(RL.RooflineReport)]
    assert fields == [f.name for f in dataclasses.fields(R.RooflineReport)]
    kw = dict(arch="llama3.2-1b", shape="train_4k", mesh="16x16", chips=256,
              flops_per_device=1.5e12, bytes_per_device=2e9,
              coll_bytes_per_device=3e8, coll_breakdown={"total": 3e8},
              compute_s=1.5e-3, memory_s=6e-4, collective_s=7e-4,
              dominant="compute", model_flops=3e14, useful_flops_ratio=0.78,
              memory_report="")
    assert RL.format_row(RL.RooflineReport(**kw)) == R.format_row(R.RooflineReport(**kw))
    assert (RL.C_ACT_TRAIN, RL.C_ACT_FWD) == (R.C_ACT_TRAIN, R.C_ACT_FWD)
    # the card's data-sheet rates in place of the TPU's
    assert (RL.PEAK_FLOPS, RL.HBM_BW, RL.LINK_BW) == (989e12, 3.35e12, 450e9)


_REF_CFGS = """
import json, sys
import jax.numpy as jnp
from repro.configs import ARCHS, get_config
from repro.launch.dryrun import MEGA_PARAMS, build_safl_cfg, topology_for
out = {"mega": MEGA_PARAMS}
for arch in ARCHS:
    cfg = get_config(arch)
    s = build_safl_cfg(cfg, local_steps=2)
    out[arch] = dict(topology=topology_for(cfg), moment=jnp.dtype(s.server.moment_dtype).name,
                     server=s.server.name, lr=s.server.lr, kind=s.sketch.kind,
                     ratio=s.sketch.ratio, min_b=s.sketch.min_b,
                     client_lr=s.client_lr, local_steps=s.local_steps)
print(json.dumps(out))
"""


def test_build_safl_cfg_and_topology_match_reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", _REF_CFGS], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    want = json.loads(r.stdout.strip().splitlines()[-1])
    assert D.MEGA_PARAMS == want["mega"]
    names = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    for arch in ARCHS:
        cfg, w = get_config(arch), want[arch]
        s = D.build_safl_cfg(cfg, local_steps=2)
        assert D.topology_for(cfg) == w["topology"], arch
        assert s.server.moment_dtype == names[w["moment"]], arch
        assert (s.server.name, s.server.lr, s.sketch.kind, s.sketch.ratio,
                s.sketch.min_b, s.client_lr, s.local_steps) == (
            w["server"], w["lr"], w["kind"], w["ratio"], w["min_b"],
            w["client_lr"], w["local_steps"]), arch
