"""The port's intrinsic dimension (paper Def. 3.1, Fig. 5) against the
reference's: the quadratic with a known spectrum, and on the bench's
2-layer LM (benchmarks/run.py) the HVP, Lanczos from the reference's own
start vector, and the whole estimate from the same key."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.intrinsic_dim import intrinsic_dimension as r_intrinsic
from repro.core.intrinsic_dim import lanczos as r_lanczos
from repro.core.intrinsic_dim import make_hvp as r_make_hvp
from repro.data.synthetic import BigramLMData, LMDataConfig
from repro.models import ModelConfig as RModel
from repro.models import init_params as r_init
from repro.models import loss_fn as r_loss
from repro_torch import prng
from repro_torch.checkpoint.io import params_from_numpy
from repro_torch.core.intrinsic_dim import intrinsic_dimension, lanczos, make_hvp
from repro_torch.models.config import ModelConfig as TModel
from repro_torch.models.model import loss_fn as t_loss
from test_torch_zoo_dense import flat
from torch_priority import lower_priority  # noqa: F401 (autouse)

torch.set_num_threads(2)

# the bench's model and Fig. 5 batch (benchmarks/run.py: MODEL, fig5)
BENCH = dict(name="bench", arch_type="dense", num_layers=2, d_model=64,
             num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128)


def test_quadratic_known_spectrum():
    """L(x) = x^T A x / 2 has Hessian A: the HVP is A v, and lambda_max and
    I are recovered (tests/test_substrates.py::test_hvp_and_intrinsic_dim_quadratic)."""
    eigs = np.array([4.0, 2.0, 1.0, 0.5, 0.25, 0.1, 0.05, 0.0])
    d = eigs.size
    # the reference test's matrix; the probes (prng key 0) are its own too
    q, _ = np.linalg.qr(np.asarray(jax.random.normal(jax.random.key(0), (d, d))))
    A = torch.tensor(q @ np.diag(eigs) @ q.T, dtype=torch.float32)
    params = {"x": torch.randn(d, generator=torch.Generator().manual_seed(1))}
    loss = lambda p, b: 0.5 * p["x"] @ A @ p["x"]
    mv, dim = make_hvp(loss, params, None)
    assert dim == d
    v = torch.randn(d, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(mv(v), A @ v, rtol=1e-4, atol=1e-5)
    out = intrinsic_dimension(loss, params, None, num_iters=d, num_probes=4)
    want_i = eigs.sum() / eigs.max()
    assert abs(out["lambda_max"] - 4.0) < 0.05
    assert abs(out["intrinsic_dim"] - want_i) / want_i < 0.35
    assert out["ambient_dim"] == d


@pytest.fixture(scope="module")
def bench():
    """Both packages' HVP at the reference's init of the bench model, on
    its Fig. 5 batch (16 sequences of 32 bigram tokens)."""
    rm, tm = RModel(**BENCH), TModel(**BENCH)
    data = BigramLMData(LMDataConfig(vocab_size=128, seq_len=32, num_clients=1))
    batch = data.client_batch(0, 16, seed=0)
    rparams = r_init(rm, jax.random.key(0))
    tparams = params_from_numpy(flat(rparams), "cpu")
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    rloss = lambda p, b: r_loss(rm, p, b)
    tloss = lambda p, b: t_loss(tm, p, b, remat=False)   # torch.func: no checkpoint
    return dict(r=(rloss, rparams, batch), t=(tloss, tparams, tbatch),
                r_hvp=r_make_hvp(rloss, rparams, batch),
                t_hvp=make_hvp(tloss, tparams, tbatch))


def test_hvp_matches_reference(bench):
    """Forward-over-reverse in both packages on the same vector: float32
    forward and two derivative passes summed in other orders, ~1.6e-6 of
    the largest entry (measured), held to 1e-5 of it plus 1e-4
    relative."""
    (rmv, d), (tmv, d2) = bench["r_hvp"], bench["t_hvp"]
    assert d == d2 == 90_432
    v = np.random.RandomState(0).randn(d).astype(np.float32)
    want = np.asarray(rmv(jnp.asarray(v)))
    got = tmv(torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


def tridiagonal(evals, weights):
    """(alphas, betas) of the tridiagonal whose eigenvalues are ``evals``
    and whose eigenvectors' squared first components are ``weights``:
    Lanczos on diag(evals) from sqrt(weights) rebuilds it."""
    q, q_prev, beta = np.sqrt(weights), 0.0, 0.0
    Q, alphas, betas = [q], [], []
    for i in range(len(evals)):
        w = evals * q
        alphas.append(float(q @ w))
        w = w - alphas[-1] * q - beta * q_prev
        for _ in range(2):
            for u in Q:
                w = w - (u @ w) * u
        if i == len(evals) - 1:
            break
        beta = float(np.linalg.norm(w))
        betas.append(beta)
        q_prev, q = q, w / beta
        Q.append(q)
    return np.array(alphas), np.array(betas)


def test_lanczos_matches_reference_from_its_start_vector(bench):
    """20 iterations from the reference's own v0 in both packages (float64
    vectors; the float32 HVPs differ by ~1e-6 relative): the Ritz values
    and the rebuilt alpha and beta within 1e-5 of lambda_max (measured
    ~8e-7), lambda_max itself to 1e-6 relative (measured ~2e-8), the
    quadrature weights to 1e-5."""
    (rmv, d), (tmv, _) = bench["r_hvp"], bench["t_hvp"]
    key = jax.random.key(3)
    v0 = np.asarray(jax.random.normal(key, (d,)), np.float64)
    ev_r, w_r = r_lanczos(rmv, d, 20, key, v0=v0)
    ev_t, w_t = lanczos(tmv, d, 20, None, v0=v0, device="cpu")
    lam = np.abs(ev_r).max()
    np.testing.assert_allclose(ev_t, ev_r, rtol=0, atol=1e-5 * lam)
    np.testing.assert_allclose(np.abs(ev_t).max(), lam, rtol=1e-6)
    np.testing.assert_allclose(w_t, w_r, rtol=0, atol=1e-5)
    (a_r, b_r), (a_t, b_t) = tridiagonal(ev_r, w_r), tridiagonal(ev_t, w_t)
    np.testing.assert_allclose(a_t, a_r, rtol=0, atol=1e-5 * lam)
    np.testing.assert_allclose(b_t, b_r, rtol=0, atol=1e-5 * lam)


def test_intrinsic_dimension_matches_reference_from_the_same_key(bench):
    """The bench's Fig. 5 estimate (8 iterations, 2 probes) from key 0 in
    both packages.  The probes' start vectors agree up to erfinv's float32
    tail gap (~2e-5, ROADMAP §C); I, lambda_max and trace|H| agree to
    1e-4 relative (measured ~5e-6)."""
    want = r_intrinsic(*bench["r"], num_iters=8, num_probes=2,
                       key=jax.random.key(0))
    got = intrinsic_dimension(*bench["t"], num_iters=8, num_probes=2,
                              key=prng.key(0))
    assert got["ambient_dim"] == want["ambient_dim"]
    for k in ("intrinsic_dim", "lambda_max", "trace_abs"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert got["intrinsic_dim"] < 0.05 * got["ambient_dim"]
