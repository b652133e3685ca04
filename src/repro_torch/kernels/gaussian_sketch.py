"""On-the-fly Gaussian sketch (sk/desk of Lemma A.2), R never stored.

Counterpart of ``repro/kernels/gaussian_sketch.py``.  R is ``b x n``; its
transpose is cut into ``(TILE_N, b)`` tiles, and element ``(row, col)`` of
tile ``t`` is a pure function of ``(seed, t, row, col)``:

    ctr = seed * 0x9E3779B1 + t * 0x85EBCA77 + row * 2b + col * 2   (uint32)
    u1, u2 = uniform01(splitmix32(ctr)), uniform01(splitmix32(ctr + 1))
    R^T[t * TILE_N + row, col] = sqrt(-2 log u1) * cos(2 pi u2)

* ``gauss_tile_plain``, ``gaussian_sk_plain``, ``gaussian_desk_plain`` --
  the plain PyTorch versions: the reference's tile-by-tile contraction,
  the kernels' oracles and what runs on the CPU.  Words are held in int64
  tensors masked to 32 bits, as in ``repro_torch.prng``.
* ``gaussian_sk_cuda``, ``gaussian_desk_cuda`` -- the hand-written Hopper
  kernels (``csrc/gaussian_sketch.cu``).  sk is two launches: partial sums
  over row splits, each thread walking the rows for ``SK_COLS`` columns,
  then their sum in a fixed order; desk is one, each thread walking the
  columns for its rows.  Both make R with the PTX approximations of lg2,
  sqrt and cos (the plain versions use the accurate ones), a few ulp apart.

``LAUNCHES["gaussian_sk"]`` and ``LAUNCHES["gaussian_desk"]`` count the
kernel launches of each.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build

TILE_N = 512       # rows of R^T per tile (the reference's grid step)
SK_THREADS = 256   # threads of an sk block (csrc/gaussian_sketch.cu) ...
SK_COLS = 2        # ... and the columns each owns

M32 = 0xFFFFFFFF
_SEED_MUL, _TILE_MUL = 0x9E3779B1, 0x85EBCA77
_TWO_PI = float(np.float32(2.0 * np.pi))

LAUNCHES = {"gaussian_sk": build.LaunchCount(),
            "gaussian_desk": build.LaunchCount()}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for words x < 2**32: the constant is split into
    16-bit halves, so no int64 product reaches 2**63."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def splitmix32(x: torch.Tensor) -> torch.Tensor:
    """The reference's counter mixer (splitmix64 constants cut to 32 bits)."""
    x = (x + 0x9E3779B9) & M32
    x = _mul32(x ^ (x >> 16), 0x85EBCA6B)
    x = _mul32(x ^ (x >> 13), 0xC2B2AE35)
    return x ^ (x >> 16)


def _uniform01(bits: torch.Tensor) -> torch.Tensor:
    # the top 24 bits -> (0, 1]; never 0, so log() is finite
    return ((bits >> 8).to(torch.float32) + 1.0) * (2.0 ** -24)


def tile_counters(seed: int, tiles: torch.Tensor, tile_n: int,
                  b: int) -> torch.Tensor:
    """The uint32 counters (as int64) of the tiles ``tiles`` (T,):
    (T, tile_n, b)."""
    dev = tiles.device
    base = (((int(seed) * _SEED_MUL) & M32)
            + tiles.to(torch.int64) * _TILE_MUL) & M32
    rows = torch.arange(tile_n, dtype=torch.int64, device=dev) * (2 * b)
    cols = torch.arange(b, dtype=torch.int64, device=dev) * 2
    return (base[:, None, None] + rows[:, None] + cols) & M32


def _gauss(ctr: torch.Tensor) -> torch.Tensor:
    u1 = _uniform01(splitmix32(ctr))
    u2 = _uniform01(splitmix32((ctr + 1) & M32))
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI * u2)


def gauss_tile_plain(seed: int, tile: int, tile_n: int, b: int,
                     device="cpu") -> torch.Tensor:
    """The reference's ``_gauss_tile``: the (tile_n, b) tile of R^T."""
    tiles = torch.tensor([tile], dtype=torch.int64, device=device)
    return _gauss(tile_counters(seed, tiles, tile_n, b))[0]


def _tile_groups(n_tiles: int, b: int):
    """Tile ranges whose R^T slab stays near 2**24 elements."""
    step = max(1, (1 << 24) // (TILE_N * max(b, 1)))
    return [(t, min(t + step, n_tiles)) for t in range(0, n_tiles, step)]


def _slab(seed: int, t0: int, t1: int, b: int, device) -> torch.Tensor:
    tiles = torch.arange(t0, t1, dtype=torch.int64, device=device)
    return _gauss(tile_counters(seed, tiles, TILE_N, b)).reshape(-1, b)


def gaussian_sk_plain(seed: int, x: torch.Tensor, b: int) -> torch.Tensor:
    """sk(x) = R x / sqrt(b), R regenerated tile by tile."""
    n = x.shape[0]
    n_tiles = -(-n // TILE_N)
    xp = torch.nn.functional.pad(x.to(torch.float32), (0, n_tiles * TILE_N - n))
    acc = torch.zeros(b, dtype=torch.float32, device=x.device)
    for t0, t1 in _tile_groups(n_tiles, b):
        acc = acc + xp[t0 * TILE_N:t1 * TILE_N] @ _slab(seed, t0, t1, b, x.device)
    return acc / float(np.sqrt(np.float32(b)))


def gaussian_desk_plain(seed: int, s: torch.Tensor, n: int) -> torch.Tensor:
    """desk(s) = R^T s / sqrt(b), from the same tiles as sk."""
    b = s.shape[0]
    n_tiles = -(-n // TILE_N)
    sf = s.to(torch.float32)
    out = torch.cat([_slab(seed, t0, t1, b, s.device) @ sf
                     for t0, t1 in _tile_groups(n_tiles, b)])
    return out[:n] / float(np.sqrt(np.float32(b)))


# ---------------------------------------------------------------------------
# the Hopper kernels
# ---------------------------------------------------------------------------

def _check(name: str, v: torch.Tensor) -> None:
    if not v.is_cuda:
        raise ValueError(f"{name} needs a CUDA tensor")
    if v.dtype != torch.float32 or v.dim() != 1 or not v.is_contiguous():
        raise ValueError(f"{name} takes a contiguous 1-D float32 tensor, got "
                         f"{tuple(v.shape)} {v.dtype}")


def _launch(kernel: str, fn_name: str, argtypes, *args) -> None:
    fn = getattr(build.load("gaussian_sketch"), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err}")
    LAUNCHES[kernel].n += 1


def _sk_splits(n: int, b: int, slots: int) -> int:
    """Row splits of the sk grid on a card that holds ``slots`` blocks at
    once.  Split y of ``splits`` takes tiles [n_tiles * y // splits,
    n_tiles * (y + 1) // splits).  Of the splits that fill one to four
    waves, the one whose blocks keep the card busiest: blocks over the slots
    of the waves they take, times a split's mean tiles over its most."""
    n_tiles = -(-n // TILE_N)
    col_blocks = -(-b // (SK_THREADS * SK_COLS))
    best, best_busy = 1, 0.0
    for waves in range(1, 5):
        splits = max(1, min(n_tiles, waves * slots // col_blocks))
        blocks = col_blocks * splits
        busy = (blocks / (slots * -(-blocks // slots))
                * n_tiles / (splits * -(-n_tiles // splits)))
        if busy > best_busy + 1e-9:
            best, best_busy = splits, busy
    return best


@functools.lru_cache(maxsize=None)
def _sk_slots(index: int) -> int:
    """The sk blocks card ``index`` holds at once (occupancy x SMs)."""
    n = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = build.load("gaussian_sketch").gaussian_sk_slots(ctypes.byref(n))
    if err != 0 or n.value <= 0:
        raise RuntimeError(f"gaussian_sk_slots failed: CUDA error {err}")
    return n.value


def _aligned(v: torch.Tensor) -> torch.Tensor:
    """v, or a copy of it on 16 bytes: the kernels read it as float4."""
    return v if v.data_ptr() % 16 == 0 else v.clone()


def gaussian_sk_cuda(seed: int, x: torch.Tensor, b: int) -> torch.Tensor:
    """The Hopper kernels' route: sk of (n,) float32 on CUDA -> (b,)."""
    _check("gaussian_sk_cuda", x)
    n = x.shape[0]
    if not 0 < b < 1 << 24:
        raise ValueError(f"b must be in [1, 2**24), got {b}")
    out = torch.empty(b, dtype=torch.float32, device=x.device)
    if n == 0:
        return out.zero_()
    x = _aligned(x)
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    splits = _sk_splits(n, b, _sk_slots(index))
    partials = torch.empty((splits, b), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    vp, ll, i, u32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint32
    _launch("gaussian_sk", "gaussian_sk_partials", [u32, vp, ll, i, i, vp, vp],
            int(seed) & M32, x.data_ptr(), n, b, splits, partials.data_ptr(),
            stream)
    _launch("gaussian_sk", "gaussian_sk_reduce", [vp, i, i, vp, vp],
            partials.data_ptr(), splits, b, out.data_ptr(), stream)
    return out


def gaussian_desk_cuda(seed: int, s: torch.Tensor, n: int) -> torch.Tensor:
    """The Hopper kernel's route: desk of (b,) float32 on CUDA -> (n,)."""
    _check("gaussian_desk_cuda", s)
    b = s.shape[0]
    if not 0 < b < 1 << 24:
        raise ValueError(f"b must be in [1, 2**24), got {b}")
    out = torch.empty(n, dtype=torch.float32, device=s.device)
    if n == 0:
        return out
    s = _aligned(s)
    stream = torch.cuda.current_stream(s.device).cuda_stream
    vp, ll, i, u32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint32
    _launch("gaussian_desk", "gaussian_desk", [u32, vp, i, ll, vp, vp],
            int(seed) & M32, s.data_ptr(), b, n, out.data_ptr(), stream)
    return out
