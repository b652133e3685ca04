"""Counter-based random streams, bit-identical to the ``jax.random`` calls
the reference makes.

The reference draws every sketch operator and every token from
``jax.random`` with the threefry2x32 generator in its partitionable mode
(``jax_threefry_partitionable=True``, the default of jax >= 0.5).  This
module reproduces those streams bit for bit, so a round of the port and a
round of the reference under the same key use the same hashes, signs and
batches.

A key is a pair of Python ints ``(k0, k1)``, each an unsigned 32-bit word:
deriving keys (``key``, ``fold_in``, ``split``) is scalar work done on the
host, so it never synchronises with the device.  The bulk draws
(``random_bits``, ``randint``, ``uniform``, ``bernoulli``, ``permutation``,
``choice``, ``rademacher``, ``normal``) run on the tensor device the caller
names.  Every stream is a pure function of its key, which is a pure
function of ``(seed, round, client, leaf)``: keys are the port's explicit
generators.

Words are held in int64 tensors masked to 32 bits, because torch's uint32
support is partial.  The same ``_threefry2x32`` body serves Python ints
(key derivation) and int64 tensors (bulk draws): both support the
``+ & ^ << >>`` operators it uses.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

Key = tuple[int, int]
Shape = Union[int, Sequence[int]]

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def _threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (jax ``_threefry2x32_lowering``).

    ``k0, k1`` are 32-bit words; ``x0, x1`` are counter words (ints or int64
    tensors, broadcast against each other).  Returns the two output words.
    """
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def key(seed: int) -> Key:
    """``jax.random.key(seed)`` for a seed in [0, 2**32)."""
    seed = int(seed)
    if not 0 <= seed <= M32:
        raise ValueError(f"seed must be in [0, 2**32), got {seed}")
    return (0, seed)


def fold_in(k: Key, data: int) -> Key:
    """``jax.random.fold_in``: hash the counter pair ``(0, data)``."""
    return _threefry2x32(k[0], k[1], 0, int(data) & M32)


def split(k: Key, num: int = 2) -> list[Key]:
    """``jax.random.split`` (fold-like partitionable variant): key i is the
    hash of the counter pair ``(0, i)``."""
    return [_threefry2x32(k[0], k[1], 0, i) for i in range(int(num))]


def _shape(shape: Shape) -> tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(int(s) for s in shape)


def _bits(k0, k1, n: int, device) -> torch.Tensor:
    """XOR of the two threefry words of counters ``(0, i)``, i < n, under
    the key words ``k0, k1`` (ints, or int64 tensors of shape (N, 1) for N
    keys at once)."""
    if n >= 1 << 32:
        raise NotImplementedError("random_bits supports fewer than 2**32 elements")
    ctr = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = _threefry2x32(k0, k1, 0, ctr)
    return y0 ^ y1


def random_bits(k: Key, shape: Shape, device) -> torch.Tensor:
    """32 random bits per element (int64 in [0, 2**32)): jax's partitionable
    ``random_bits``, which hashes the flat element index."""
    shape = _shape(shape)
    return _bits(k[0], k[1], math.prod(shape), device).reshape(shape)


def randint(k: Key, shape: Shape, minval: int, maxval: int,
            device) -> torch.Tensor:
    """``jax.random.randint(k, shape, minval, maxval)`` as int64 values.

    Two 32-bit draws combined modulo the span, exactly as jax's
    ``_randint``: ``((hi % span) * (2**32 % span) + lo % span) % span`` with
    the product wrapped to 32 bits.
    """
    k1, k2 = split(k)
    hi = random_bits(k1, shape, device)
    lo = random_bits(k2, shape, device)
    span = maxval - minval
    if span <= 0:
        span = 1
    mult = (1 << 16) % span
    mult = ((mult * mult) & M32) % span     # uint32 product, as jax wraps it
    off = ((hi % span) * mult) & M32
    off = (off + lo % span) & M32
    return off % span + minval


def _to_unit(bits: torch.Tensor) -> torch.Tensor:
    # the top 23 bits as the mantissa of a float in [1, 2), minus one (exact)
    return (bits >> 9).to(torch.float32) * (2.0 ** -23)


def uniform(k: Key, shape: Shape, device) -> torch.Tensor:
    """``jax.random.uniform(k, shape)`` in float32 on [0, 1)."""
    return _to_unit(random_bits(k, shape, device))


def uniform_many(keys: Sequence[Key], shape: Shape, device) -> torch.Tensor:
    """``stack([uniform(k, shape) for k in keys])`` in one pass over the
    device: (len(keys), *shape) float32."""
    shape = _shape(shape)
    kw = torch.tensor(keys, dtype=torch.int64, device=device).reshape(-1, 2, 1)
    bits = _bits(kw[:, 0], kw[:, 1], math.prod(shape), device)
    return _to_unit(bits).reshape((len(keys),) + shape)


def bernoulli(k: Key, p: float, shape: Shape, device) -> torch.Tensor:
    """``jax.random.bernoulli(k, p, shape)`` (its default ``mode="low"``):
    ``uniform(k, shape) < p`` with ``p`` rounded to float32, as jax rounds a
    Python float.  Shape ``()`` draws one scalar."""
    return uniform(k, shape, device) < float(np.float32(p))


def permutation(k: Key, n: int, device) -> torch.Tensor:
    """``jax.random.permutation(k, n)`` as int64 values: jax's ``_shuffle``
    of ``arange(n)``, ``ceil(3 ln n / ln(2**32 - 1))`` rounds of ``k, sub =
    split(k)`` and a stable sort by ``random_bits(sub, (n,))``.  Stability
    keeps tied 32-bit keys in their incoming order, as XLA's sort does."""
    n = int(n)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(n, dtype=torch.int64, device=device)
    for _ in range(rounds):
        k, sub = split(k)
        x = x[torch.sort(random_bits(sub, (n,), device), stable=True).indices]
    return x


def choice(k: Key, n: int, shape: Shape, device) -> torch.Tensor:
    """``jax.random.choice(k, n, shape, replace=False)`` from ``arange(n)``
    with uniform probabilities, as int64 values: the first ``prod(shape)``
    entries of ``permutation(k, n)``."""
    shape = _shape(shape)
    m = math.prod(shape)
    if m > n:
        raise ValueError(f"cannot take {m} of {n} without replacement")
    return permutation(k, n, device)[:m].reshape(shape)


def rademacher(k: Key, shape: Shape, device) -> torch.Tensor:
    """``jax.random.rademacher(k, shape, float32)``: +1 where the uniform
    draw is below 0.5, that is where bit 31 of the draw is clear."""
    bits = random_bits(k, shape, device)
    return 1.0 - 2.0 * (bits >> 31).to(torch.float32)


# jax's ``_normal_real`` bounds, in float32: lo = nextafter(-1, 0); hi - lo
# rounds to 2.0 in float32, as jax computes it
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_NORMAL_SPAN = float(np.float32(1.0) - np.float32(_NORMAL_LO))
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def _open_unit(f: torch.Tensor) -> torch.Tensor:
    # [0, 1) uniforms to jax's (lo, 1): max(lo, f * (hi - lo) + lo)
    return torch.clamp(f * _NORMAL_SPAN + _NORMAL_LO, min=_NORMAL_LO)


def normal_uniform(k: Key, shape: Shape, device) -> torch.Tensor:
    """The uniforms ``jax.random.normal`` feeds to ``erfinv``:
    ``uniform(k, shape, minval=lo, maxval=1)``, that is
    ``max(lo, f * (hi - lo) + lo)`` on ``(-1, 1)``."""
    return _open_unit(uniform(k, shape, device))


def normal(k: Key, shape: Shape, device) -> torch.Tensor:
    """``jax.random.normal(k, shape, float32)``: ``sqrt(2) * erfinv(u)``.
    The uniforms are the reference's bit for bit; ``erfinv`` is PyTorch's,
    within ~1e-5 relative of XLA's float32 polynomial."""
    return torch.erfinv(normal_uniform(k, shape, device)) * _SQRT2


def normal_many(keys: Sequence[Key], shape: Shape, device) -> torch.Tensor:
    """``stack([normal(k, shape) for k in keys])`` in one pass over the
    device: (len(keys), *shape) float32."""
    return torch.erfinv(_open_unit(uniform_many(keys, shape, device))) * _SQRT2
