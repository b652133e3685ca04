"""The Gaussian sketch family of the port against the reference.

Two R's live here, as in the reference:

* the family of ``core/sketch.py``/``core/packed.py`` draws R chunk by
  chunk with ``jax.random.normal``; the port's ``prng.normal`` gives the
  same uniforms bit for bit, and ``erfinv`` within ~1e-5 relative;
* the on-the-fly kernels (``kernels/gaussian_sketch.py``) regenerate R from
  splitmix32 counters; the port's plain versions give the same counters and
  mixed bits bit for bit, and the floats within an ulp or two.

Shapes are small: the port's threefry runs as PyTorch integer ops here.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sketch as rsk
from repro.kernels import ref
from repro.kernels import gaussian_sketch as rgs
from repro_torch import prng
from repro_torch.core import sketch as tsk
from repro_torch.kernels import gaussian_sketch as tgs
from repro_torch.kernels import ops

from torch_priority import lower_priority  # noqa: F401 (autouse)

torch.set_num_threads(2)

# XLA's float32 erf_inv is a polynomial good to ~1e-5 relative in the
# tails (|u| near 1); torch.erfinv is closer to exact.  Measured: <= 6e-6.
NORMAL_TOL = dict(rtol=2e-5, atol=1e-6)
# log/cos of two float32 libraries differ by an ulp or two; near a zero of
# cos the difference is absolute, ~|r| * ulp(2 pi) <= 5.8 * 4.8e-7
TILE_TOL = dict(rtol=1e-6, atol=5e-6)
# float32 sums of up to 2000 products in another order (plain: matmul per
# tile group; Pallas: dot per tile), outputs of size ~10: a few ulps
SK_TOL = dict(rtol=1e-5, atol=1e-5)
# sketches of the family: sums of a few hundred unit-scale products in
# another order, plus the erfinv gap above, random in sign
FAMILY_TOL = dict(rtol=1e-4, atol=1e-5)
CHUNK = 128  # small gaussian_chunk on both sides: several chunks per leaf

KERNEL_SHAPES = [(100, 16), (513, 64), (2000, 128), (1500, 128), (900, 64)]


@pytest.mark.parametrize("seed", [0, 42, 2**31 + 5])
@pytest.mark.parametrize("shape", [(1,), (333,), (129, 40)])
def test_normal_matches_jax(seed, shape):
    jk = jax.random.fold_in(jax.random.key(seed), 5)
    pk = prng.fold_in(prng.key(seed), 5)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    want = np.asarray(jax.random.uniform(jk, shape, jnp.float32, lo, 1.0))
    got = prng.normal_uniform(pk, shape, "cpu").numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_allclose(prng.normal(pk, shape, "cpu").numpy(),
                               np.asarray(jax.random.normal(jk, shape)),
                               **NORMAL_TOL)


@pytest.mark.parametrize("seed,tile,tile_n,b", [(7, 0, 512, 128), (11, 3, 64, 16),
                                                (2**32 - 1, 5, 512, 70)])
def test_gauss_tile_plain_matches_reference(seed, tile, tile_n, b):
    """Counters and mixed bits bitwise (numpy's uint64 formula of
    ``ref.gaussian_tile_ref``; the Pallas module's ``_splitmix32``), the
    tile allclose to the float64 oracle and to ``_gauss_tile``."""
    ctr = tgs.tile_counters(seed, torch.tensor([tile]), tile_n, b)[0]
    rows, cols = np.meshgrid(np.arange(tile_n, dtype=np.uint64),
                             np.arange(b, dtype=np.uint64), indexing="ij")
    base = (np.uint64(seed) * np.uint64(0x9E3779B1)
            + np.uint64(tile) * np.uint64(0x85EBCA77)) & np.uint64(0xFFFFFFFF)
    want = (base + rows * np.uint64(2 * b) + cols * np.uint64(2)) & np.uint64(0xFFFFFFFF)
    np.testing.assert_array_equal(ctr.numpy(), want.astype(np.int64))
    for c in (ctr, (ctr + 1) & tgs.M32):
        bits = np.asarray(rgs._splitmix32(jnp.asarray(c.numpy().astype(np.uint32))))
        np.testing.assert_array_equal(tgs.splitmix32(c).numpy(), bits.astype(np.int64))
    got = tgs.gauss_tile_plain(seed, tile, tile_n, b).numpy()
    np.testing.assert_allclose(got, ref.gaussian_tile_ref(seed, tile, tile_n, b),
                               **TILE_TOL)
    jt = rgs._gauss_tile(jnp.uint32(seed), jnp.int32(tile), tile_n, b)
    np.testing.assert_allclose(got, np.asarray(jt), **TILE_TOL)


@pytest.mark.parametrize("n,b", KERNEL_SHAPES)
def test_gaussian_kernels_plain_vs_pallas_interpret(n, b):
    rng = np.random.RandomState(n + b)
    x = rng.randn(n).astype(np.float32)
    s = rng.randn(b).astype(np.float32)
    seed = jnp.array(11, jnp.uint32)
    want = np.asarray(rgs.gaussian_sk_pallas(seed, jnp.asarray(x), b))
    np.testing.assert_allclose(ops.gaussian_sk(11, torch.from_numpy(x), b).numpy(),
                               want, **SK_TOL)
    want = np.asarray(rgs.gaussian_desk_pallas(seed, jnp.asarray(s), n))
    np.testing.assert_allclose(ops.gaussian_desk(11, torch.from_numpy(s), n).numpy(),
                               want, **SK_TOL)


# The Hopper kernels' integer and float algebra (csrc/gaussian_sketch.cu),
# written again in numpy and held bit for bit against the reference's
# _splitmix32, _uniform01 and counters: the kernels run only on a card.
_U32 = np.uint32
_GOLDEN, _SEED_MUL, _TILE_MUL = 0x9E3779B9, 0x9E3779B1, 0x85EBCA77


def _masked_bits(x):
    """top24()'s integer part, given x = ctr + 0x9E3779B9 (splitmix32's
    first add carried by the counter): the rest of the mix, its last xor
    also clearing the low 8 bits."""
    x = np.asarray(x, np.uint32)
    x = (x ^ (x >> _U32(16))) * _U32(0x85EBCA6B)
    x = (x ^ (x >> _U32(13))) * _U32(0xC2B2AE35)
    return (x ^ (x >> _U32(16))) & _U32(0xFFFFFF00)


def _uniforms(masked):
    """gauss()'s u1 and u2 - 1/2: I2FP of 256 k, then one FFMA each.  The
    exact sum fits float64, so float64 then one rounding to float32 is the
    FFMA."""
    f = masked.astype(np.float32)
    assert np.array_equal(f.astype(np.float64), masked.astype(np.float64))
    f = f.astype(np.float64) * 2.0 ** -32
    half = np.float64(np.float32(2.0 ** -24 - 0.5))
    return (f + 2.0 ** -24).astype(np.float32), (f + half).astype(np.float32)


def _reference_counters(seed, tiles, rows, cols, b):
    """_gauss_tile's counters, in its own uint32 arithmetic."""
    base = (jnp.uint32(seed) * jnp.uint32(_SEED_MUL)
            + jnp.asarray(tiles, jnp.uint32) * jnp.uint32(_TILE_MUL))
    return np.asarray(base + jnp.asarray(rows, jnp.uint32) * jnp.uint32(2 * b)
                      + jnp.asarray(cols, jnp.uint32) * jnp.uint32(2))


def _hold_to_reference(x, ctr):
    """The kernel's x = ctr + golden, its two streams' bits and uniforms,
    against the reference's at the counters ctr."""
    np.testing.assert_array_equal(x - _U32(_GOLDEN), ctr)
    mask = _U32(0xFFFFFF00)
    for xs, c in ((x, ctr), (x + _U32(1), ctr + _U32(1))):
        bits = np.asarray(rgs._splitmix32(jnp.asarray(c)))
        np.testing.assert_array_equal(_masked_bits(xs), bits & mask)
    u1, _ = _uniforms(_masked_bits(x))
    _, v2 = _uniforms(_masked_bits(x + _U32(1)))
    want1 = np.asarray(rgs._uniform01(rgs._splitmix32(jnp.asarray(ctr))))
    want2 = np.asarray(rgs._uniform01(rgs._splitmix32(jnp.asarray(ctr + _U32(1)))))
    np.testing.assert_array_equal(u1.view(np.uint32), want1.view(np.uint32))
    np.testing.assert_array_equal(v2.astype(np.float64), want2.astype(np.float64) - 0.5)


# b: a small leaf, the lm25m plan's largest, and one where 2b * row wraps
# past 2**32 within a tile (2b * 511 > 2**32 from b = 4,202,634)


def test_kernel_form_of_r_is_the_reference_tile():
    """R = -sqrt(2 ln 2) sqrt(|log2 u1|) cos(2 pi (u2 - 1/2)), the form the
    kernels compute (the constant on the finished sums), from the kernels'
    u1 and u2 - 1/2 in float64, against _gauss_tile."""
    seed, tile, b = 2**32 - 1, 5, 70
    rows = np.arange(tgs.TILE_N, dtype=np.uint32)[:, None]
    cols = np.arange(b, dtype=np.uint32)
    x = _reference_counters(seed, tile, rows, cols, b) + _U32(_GOLDEN)
    u1, _ = _uniforms(_masked_bits(x))
    _, v2 = _uniforms(_masked_bits(x + _U32(1)))
    r = (-np.sqrt(2 * np.log(2)) * np.sqrt(np.abs(np.log2(u1.astype(np.float64))))
         * np.cos(2 * np.pi * v2.astype(np.float64)))
    want = np.asarray(rgs._gauss_tile(jnp.uint32(seed), jnp.int32(tile), tgs.TILE_N, b))
    np.testing.assert_allclose(r, want, **TILE_TOL)


def _gcfgs(mode, **extra):
    base = dict(kind="gaussian", ratio=0.1, min_b=8, mode=mode,
                gaussian_chunk=CHUNK)
    return rsk.SketchConfig(**base), tsk.SketchConfig(**base, **extra)
