"""repro_torch.fed.participation and the masked aggregation against the
reference.

Cohort masks are integer-valued outputs of bit-identical uniforms and a
stable sort, so every policy's mask (and the weighted dict of
``ImportanceParticipation``) is pinned bit for bit to the reference's
over rounds 0..31.  The masked means sum float32 terms in another order
than XLA, so they are held at rtol 1e-6; inside the port an all-ones mask
is bit for bit the unmasked path, as in the reference.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import safl as rsafl
from repro.fed import participation as rpart
from repro_torch import prng
from repro_torch.core import safl as tsafl
from repro_torch.fed import participation as tpart
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_params, loss_fn
from test_torch_safl import DATA, QUICK_KW, _cfgs, _samplers
from torch_priority import lower_priority  # noqa: F401 (autouse)

torch.set_num_threads(2)

G = 5
ROUNDS = 32
PROBS = (0.1, 0.3, 0.2, 0.15, 0.25)
MEAN_TOL = dict(rtol=1e-6, atol=1e-7)


def _policies(pkg):
    """The five policies (Importance with non-uniform and uniform probs,
    AvailabilityTrace as a custom trace and as round_robin), built alike
    in either package."""
    return {
        "uniform": pkg.UniformParticipation(G, frac=0.4, seed=3),
        "uniform_7_of_13": pkg.UniformParticipation(13, frac=0.5, seed=11),
        "importance": pkg.ImportanceParticipation(G, PROBS, frac=0.4, seed=3),
        "importance_uniform": pkg.ImportanceParticipation(G, (0.2,) * G,
                                                          frac=0.4, seed=3),
        "fixed": pkg.FixedCohort(G, (1, 3)),
        "trace": pkg.AvailabilityTrace(((1.0, 0.0, 0.0, 1.0, 0.0),
                                        (0.0, 1.0, 1.0, 1.0, 1.0),
                                        (0.0, 0.0, 1.0, 0.0, 0.0))),
        "round_robin": pkg.AvailabilityTrace.round_robin(G, 3),
        "full": pkg.FullParticipation(G),
    }


def _ref_masks(pol):
    f = jax.jit(pol.mask)
    return [f(jnp.int32(t)) for t in range(ROUNDS)]


@pytest.mark.parametrize("name", list(_policies(tpart)))
def test_masks_bitwise_equal_reference(name):
    rpol, tpol = _policies(rpart)[name], _policies(tpart)[name]
    assert tpol.cohort_size == rpol.cohort_size
    for t, want in enumerate(_ref_masks(rpol)):
        got = tpol.mask(t, "cpu")
        if isinstance(want, dict):
            assert tpart.is_weighted_mask(got) and rpart.is_weighted_mask(want)
            assert got["den"] == float(want["den"]) and got["n"] == int(want["n"])
            got, want = got["w"], want["w"]
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"{name} round {t}")


def test_round_variates_bitwise_and_independent_of_n():
    for t in (0, 1, 31, 12345):
        want = np.asarray(rpart.round_variates(9, 5, jnp.int32(t)))
        got = tpart.round_variates(9, 5, t, "cpu").numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tpart.round_variates(4, 5, t, "cpu").numpy(),
                                      got[:4])


def test_uniform_probs_importance_equals_uniform_bitwise():
    """Identity tilt and unit weights: the weighted mask's ``w`` is the
    uniform policy's 0/1 mask, and its static denominator the cohort size."""
    pols = _policies(tpart)
    imp, uni = pols["importance_uniform"], pols["uniform"]
    for t in range(ROUNDS):
        got = imp.mask(t, "cpu")
        assert torch.equal(got["w"], uni.mask(t, "cpu"))
        assert got["den"] == float(uni.cohort_size) == float(torch.sum(got["w"]))


def test_policy_checks():
    tpart.check_policy_clients(tpart.UniformParticipation(G), G, "here")
    with pytest.raises(ValueError, match="covers 5 clients"):
        tpart.check_policy_clients(tpart.UniformParticipation(G), 4, "here")
    with pytest.raises(AssertionError, match="saturates"):
        tpart.ImportanceParticipation(G, (0.6, 0.1, 0.1, 0.1, 0.1), frac=0.4)
    with pytest.raises(AssertionError):
        tpart.AvailabilityTrace(((0.0, 0.0),))


def _masks_both(kind):
    """(reference mask, port mask) of one kind over G clients."""
    if kind is None:
        return None, None
    if kind == "weighted":
        r = _policies(rpart)["importance"].mask(jnp.int32(2))
        return r, tpart.ImportanceParticipation(G, PROBS, frac=0.4,
                                                seed=3).mask(2, "cpu")
    m = np.asarray(kind, np.float32)
    return jnp.asarray(m), torch.from_numpy(m)


@pytest.mark.parametrize("kind", [None, [1.0, 0.0, 1.0, 1.0, 0.0],
                                  [0.0] * 5, [1.0] * 5, "weighted"])
def test_masked_mean_and_where_match_reference(kind):
    rng = np.random.RandomState(0)
    x = rng.randn(G, 3, 4).astype(np.float32)
    tree = {"a": rng.randn(G, 6).astype(np.float32),
            "b/c": rng.randn(G, 2, 3).astype(np.float32)}
    old = {k: rng.randn(*v.shape).astype(np.float32) for k, v in tree.items()}
    rmask, tmask = _masks_both(kind)
    np.testing.assert_allclose(
        tsafl.masked_mean(torch.from_numpy(x), tmask).numpy(),
        np.asarray(rsafl.masked_mean(jnp.asarray(x), rmask)), **MEAN_TOL)
    t_tree = {k: torch.from_numpy(v) for k, v in tree.items()}
    got = tsafl.masked_mean_tree(t_tree, tmask)
    want = rsafl.masked_mean_tree({k: jnp.asarray(v) for k, v in tree.items()},
                                  rmask)
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **MEAN_TOL)
    got = tsafl.masked_where_tree(tmask, t_tree,
                                  {k: torch.from_numpy(v) for k, v in old.items()})
    want = rsafl.masked_where_tree(rmask, {k: jnp.asarray(v) for k, v in tree.items()},
                                   {k: jnp.asarray(v) for k, v in old.items()})
    for k in tree:     # a select: exact
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_all_ones_mask_is_bitwise_no_mask():
    x = torch.from_numpy(np.random.RandomState(1).randn(G, 1000).astype(np.float32))
    assert torch.equal(tsafl.masked_mean(x, torch.ones(G)), tsafl.masked_mean(x))
    model = ModelConfig(**QUICK_KW)
    tcfg = _cfgs(kind="countsketch", cs_hash="independent")[1]
    _, smp = _samplers({**DATA, "vocab_size": 128}, 2)
    batch = smp.round_batch(0, device="cpu")
    params = init_params(model, torch.Generator().manual_seed(0), "cpu")
    loss = lambda p, b: loss_fn(model, p, b)
    for rnd in (tsafl.safl_round, tsafl.fedopt_round):
        full = tpart.FullParticipation(G).mask(0, "cpu")
        a = rnd(tcfg, loss, params, tsafl.init_safl(tcfg, params), batch,
                prng.key(1), part_mask=full)
        b = rnd(tcfg, loss, params, tsafl.init_safl(tcfg, params), batch,
                prng.key(1))
        assert torch.equal(a[2]["loss"], b[2]["loss"])
        for k in params:
            assert torch.equal(a[0][k], b[0][k]), (rnd.__name__, k)
