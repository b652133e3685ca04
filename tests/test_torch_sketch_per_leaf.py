"""The per-leaf sketch of a tree against the reference's
(tests/test_torch_sketch.py holds the helpers)."""

import jax
import numpy as np
import pytest

from repro.core import sketch as rsk
from repro_torch import prng
from repro_torch.core import sketch as tsk

from test_torch_sketch import CONFIGS, MODES, TOL, _cfgs, _flat, _t, _tree
from torch_priority import lower_priority  # noqa: F401 (autouse)


@pytest.mark.parametrize("kw", CONFIGS)
@pytest.mark.parametrize("mode", MODES)
def test_per_leaf_sketch_tree_matches_reference(kw, mode):
    rcfg, tcfg = _cfgs(kw, mode)
    nested, flat = _tree()

    @jax.jit        # one compile: eager dispatch would compile every op
    def ref(key, tree):
        s = rsk.sketch_tree(rcfg, key, tree)
        return s, rsk.desketch_tree(rcfg, key, s, tree)

    rs, rd = ref(jax.random.key(3), nested)
    ts = tsk.sketch_tree(tcfg, prng.key(3), _t(flat))
    if mode == "concat":
        np.testing.assert_allclose(ts.numpy(), np.asarray(rs), **TOL)
    else:
        for k, v in _flat(rs).items():
            np.testing.assert_allclose(ts[k].numpy(), v, **TOL)
    td = tsk.desketch_tree(tcfg, prng.key(3), ts, _t(flat))
    for k, v in _flat(rd).items():
        np.testing.assert_allclose(td[k].numpy(), v, **TOL)
