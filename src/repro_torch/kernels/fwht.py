"""Unnormalized fast Walsh-Hadamard transform along the last axis.

Counterpart of ``repro/kernels/fwht.py``.

* ``fwht_plain`` -- the plain PyTorch version: the reshape butterfly of
  the reference's ``core/sketch.py::fwht``, for any power-of-two length.
  It is the kernel's oracle, what runs on the CPU, and the plain ``fwht``
  of ``repro_torch.core.sketch``.
* ``fwht_rows_cuda`` -- the hand-written Hopper kernels (``csrc/fwht.cu``).
  Rows up to ``MAX_C`` take one launch of ``fwht_rows``: each thread loads
  16 consecutive floats as four 16-byte loads and runs the low stages in
  registers, the next across the lanes of its warp, the last after one
  exchange through shared memory.  Longer rows, up to ``MAX_N``, take one
  launch of ``fwht_long`` (after a memset of its counters): the
  reference's two-level Kronecker split ``H_c = H_n1 (x) H_c1``
  (``split``), pass one along the (n1, c1) rows and pass two down their
  columns, a chunk of rows at a time (``chunk_rows``) so that pass two
  reads pass one's output from the L2 cache.

The transform is bound by device-memory bytes (one read and one write of
each element against log2(C) additions), so the kernels keep every stage
out of device memory and, for long rows, the intermediate in L2.  On an
NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py) the lm25m SRHT round's
largest group, (15, 2^22), takes 0.356 ms (0.150 at the memory rate) and
the round's ten calls 0.81 ms (bound 0.30); ``PERF.md`` has the rest.
Every pass runs the plain version's stages, pairs (i, i + h) with
ascending h, so the kernels equal ``fwht_plain`` bit for bit;
``stage_bits`` lists the order the kernels run them in.

``LAUNCHES.n`` counts the calls that launched a kernel (one per call);
``DEVICE_LAUNCHES.n`` the kernels and memsets they put on the stream.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

MAX_C = 4096           # longest row one pass transforms (FWHT_MAX_C)
MAX_N = MAX_C * MAX_C  # longest row the two-pass Kronecker path transforms
THREADS = 256          # threads of every block (FWHT_THREADS)
ROW_ELEMS = 16         # consecutive floats a thread holds in a row pass
COL_VECS = 16          # float4s a thread holds in a column pass (8 when n1 = 8)
MIN_N1 = 8             # fewest rows of the (n1, c1) view of a long row
L2_CHUNK_BYTES = 16 << 20  # at most this much of pass one's output in L2

LAUNCHES = build.LaunchCount()
DEVICE_LAUNCHES = build.LaunchCount()


def fwht_plain(x: torch.Tensor) -> torch.Tensor:
    """Unnormalized FWHT along the last axis (length a power of 2)."""
    n = x.shape[-1]
    assert n & (n - 1) == 0, "FWHT length must be a power of 2"
    lead = x.shape[:-1]
    h = 1
    while h < n:
        x = x.reshape(lead + (n // (2 * h), 2, h))
        a = x[..., 0, :]
        b = x[..., 1, :]
        x = torch.cat([a + b, a - b], dim=-1).reshape(lead + (n,))
        h *= 2
    return x


def split(c: int) -> tuple[int, int]:
    """(n1, c1) with c = n1 * c1: one pass of rows c1 = c when c <= MAX_C
    (n1 = 1), else the Kronecker view (n1, c1), c1 <= MAX_C and n1 at least
    ``MIN_N1`` (the column pass's smallest tile)."""
    if c <= MAX_C:
        return 1, c
    n1 = max(MIN_N1, c // MAX_C)
    return n1, c // n1


def chunk_rows(c: int) -> int:
    """Rows of length c whose pass-one output the long kernel keeps in L2
    at once, before their pass two."""
    return max(1, L2_CHUNK_BYTES // (4 * c))


def _log2(v: int) -> int:
    return v.bit_length() - 1


def _row_bits(log_c: int) -> list[tuple[str, range]]:
    """Index bits b (stage h = 2^b) of a row pass over rows of 2^log_c, in
    the order fwht.cu's ``row_pass`` runs them, by where they run."""
    log_e = min(log_c, _log2(ROW_ELEMS))
    log_l = min(log_c - log_e, 5)
    return [("registers", range(0, log_e)), ("lanes", range(log_e, log_e + log_l)),
            ("shared", range(log_e + log_l, log_c))]


def col_layout(log_n1: int) -> dict[str, int]:
    """fwht.cu's ``ColPass<log_n1>``: row bits in registers (RB), across
    lanes (LB) and across warps (WB); column-quad bits in the lanes (QL)
    and in all (QB); the tile's columns (TC) and floats (TILE)."""
    rb = min(_log2(COL_VECS), log_n1)
    tile = THREADS * 4 << rb
    qb = _log2(tile // 4) - log_n1
    ql = min(qb, 5)
    return dict(RB=rb, LB=5 - ql, WB=log_n1 - rb - (5 - ql), QB=qb, QL=ql,
                TC=4 << qb, TILE=tile)


def stage_bits(c: int) -> list[tuple[str, str, range]]:
    """Every stage of a length-c transform as (pass, where, index bits), in
    the order the kernels run them; pass two's row bit b is bit
    log2(c1) + b of the row."""
    n1, c1 = split(c)
    plan = [("rows", where, bits) for where, bits in _row_bits(_log2(c1))]
    if n1 > 1:
        lay, lc1 = col_layout(_log2(n1)), _log2(c1)
        reg, lanes = lay["RB"], lay["RB"] + lay["LB"]
        plan += [("columns", "registers", range(lc1, lc1 + reg)),
                 ("columns", "lanes", range(lc1 + reg, lc1 + lanes)),
                 ("columns", "shared", range(lc1 + lanes, lc1 + _log2(n1)))]
    return plan


def _launch(fn_name: str, argtypes, *args) -> None:
    fn = getattr(build.load("fwht"), fn_name)
    fn.argtypes = argtypes + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    launched = ctypes.c_int(0)
    err = fn(*args, ctypes.byref(launched))
    DEVICE_LAUNCHES.n += launched.value
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err}")
    LAUNCHES.n += 1


def fwht_rows_cuda(x: torch.Tensor) -> torch.Tensor:
    """The Hopper kernels' route: FWHT of each row of (R, C) float32 on
    CUDA, C a power of two <= ``MAX_N``."""
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (R, C) float32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    r, c = x.shape
    if c & (c - 1) or c > MAX_N:
        raise ValueError(f"row length {c} must be a power of 2 <= {MAX_N}")
    if not x.is_cuda:
        raise ValueError("fwht_rows_cuda needs a CUDA tensor")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    if x.data_ptr() % 16:      # a view at an odd offset: the kernels load 16 bytes
        x = x.clone()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    n1, c1 = split(c)
    if n1 == 1:
        _launch("fwht_rows", [vp, vp, ll, i, vp],
                x.data_ptr(), out.data_ptr(), r, _log2(c), stream)
        return out
    work = torch.empty(r + 1, dtype=torch.int32, device=x.device)
    _launch("fwht_long", [vp, vp, ll, i, i, i, vp, vp],
            x.data_ptr(), out.data_ptr(), r, _log2(n1), _log2(c1),
            chunk_rows(c), work.data_ptr(), stream)
    return out
