"""The fault and sentinel configs' argument checks, the empty pool's median
and FedOPT's refusals (tests/test_torch_faults.py holds the helpers)."""

import pytest
import torch

from repro_torch import prng
from repro_torch.core.safl import fedopt_round, init_safl
from repro_torch.fed import robust as trobust
from repro_torch.fed.faults import FaultConfig as TFaultConfig
from repro_torch.fed.faults import FaultTable as TFaultTable
from repro_torch.fed.robust import SentinelConfig as TSentinel

from test_torch_faults import (cls_cfgs, cls_params, cls_sampler, port_batch,
                               t_cls_loss)
from torch_priority import lower_priority  # noqa: F401 (autouse)


def test_masked_median_of_an_empty_pool_is_inf():
    x = torch.tensor([3.0, 1.0, 2.0])
    assert float(trobust.masked_median(x, torch.zeros(3, dtype=torch.bool))) == float("inf")
    assert float(trobust.masked_median(x, torch.tensor([True, True, False]))) == 1.0


@pytest.mark.parametrize("kw", [dict(num_clients=0), dict(num_clients=3, drop_rate=1.5),
                                dict(num_clients=3, drop_rate=0.6, nan_rate=0.6),
                                dict(num_clients=3, byzantine_scale=0.0),
                                dict(num_clients=3, start=4, stop=2),
                                dict(num_clients=3, start=-1)])
def test_fault_config_validates_its_arguments(kw):
    with pytest.raises(ValueError):
        TFaultConfig(**kw)


def test_fault_table_and_sentinel_validate_their_arguments():
    for bad in [dict(codes=()), dict(codes=((0, 1), (0,))), dict(codes=((5,),)),
                dict(codes=((0,),), byzantine_scale=-1.0)]:
        with pytest.raises(ValueError):
            TFaultTable(**bad)
    with pytest.raises(ValueError):
        TSentinel(norm_mult=-1.0)


@pytest.mark.parametrize("kw", [dict(fault_spec="spec"), dict(sentinel="sentinel"),
                                dict(codec="codec")])
def test_fedopt_rejects_faults_sentinels_and_codecs(kw):
    _, tcfg = cls_cfgs()
    _, tp = cls_params()
    with pytest.raises(ValueError):
        fedopt_round(tcfg, t_cls_loss, tp, init_safl(tcfg, tp),
                     port_batch(cls_sampler(), 0), prng.key(0), **kw)
