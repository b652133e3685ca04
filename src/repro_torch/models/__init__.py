"""The model of every assigned family (counterpart of ``repro.models``):
its config, parameter shapes and init, the training path (``forward``,
``loss_fn``) and the serving path (``init_cache``, ``decode_step``).  The
reference's mesh helpers (``param_pspecs``, ``use_mesh``) have no
counterpart yet."""

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (cache_shapes, count_params_analytic,
                                      decode_step, forward, init_cache,
                                      init_params, loss_fn, param_shapes)

__all__ = ["ModelConfig", "forward", "loss_fn", "init_params", "param_shapes",
           "decode_step", "init_cache", "cache_shapes", "count_params_analytic"]
