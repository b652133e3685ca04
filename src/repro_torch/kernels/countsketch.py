"""Batched count-sketch segment sum: ``out[g, j] = sum_{h[i] == j} x[g, i]``.

Counterpart of ``repro/kernels/countsketch.py``.  ``x`` is ``(G, n)``
float32, already multiplied by the signs; ``h`` is ``(n,)`` in ``[0, b)``
and shared by all G rows (one sketch operator per round).

* ``countsketch_clients_plain`` -- the plain PyTorch version
  (``zeros((G, b)).index_add_``), the oracle of the kernels and what runs
  on the CPU.  On CUDA, ``index_add_`` adds repeated indices with atomics in
  no fixed order, which is why it is not the card's route.
* ``countsketch_clients_cuda`` -- the hand-written Hopper route
  (``csrc/countsketch.cu``): bucketing by windows of slots (``route``).
  Each index becomes a 32-byte record ``{i, h[i], x[g0:g0 + 6, i]}`` in
  its window's range of a scratch buffer, six rows at a time:

  1. histogram: the indices of each window, counted with integer atomics;
  2. scan: ``off``, the exclusive sum of the counts (CUB block scans);
  3. placement of the records;
  4. reduce: each window's records ranked by ``(slot, i)``, and each slot
     summed from 0 in ascending i (long windows by a block-level path).

  Below ``COARSE_MIN_N`` indices (the SRHT desk scatter) all four stages
  run in one cooperative launch, whose blocks meet at a grid barrier: the
  host's cost per launch set the time there.  From it on (the uplink) they
  are separate launches, and the records move in two coalesced grouping
  passes (coarse buckets, then wide windows of ~1,600 records), because
  scattering 32-byte records one by one over a 4 GB buffer costs a DRAM
  row activation each.  The placement order depends on the run, the sum
  order does not: each slot is summed from 0.0 in ascending i, so two calls
  return the same bits, those of ``countsketch_clients_ordered``.  The
  uplink route moves ~20.5 GB (h twice, x once, the records written and
  read twice) against the 3.2 GB the function must move.

``LAUNCHES.n`` counts calls of the route that launched (G > 0);
``DEVICE_LAUNCHES.n`` counts the kernels and memsets they put on the stream,
as each entry point of the source reports them: 2 per call below
``COARSE_MIN_N``, 9 from it on (G <= 6).  The limits below that the kernels
share are read from the source, where they are defined.
"""

from __future__ import annotations

import ctypes
import re

import torch

from repro_torch.kernels import build

LAUNCHES = build.LaunchCount()
DEVICE_LAUNCHES = build.LaunchCount()


def _source_limits() -> dict[str, int]:
    text = (build.CSRC / "countsketch.cu").read_text()
    return {k: int(v) for k, v in re.findall(r"^#define (CS_\w+) (\d+)\b", text, re.M)}


_LIMITS = _source_limits()
ROWS = _LIMITS["CS_ROWS"]               # rows of x per record
BIG_SLOTS = _LIMITS["CS_BIG_SLOTS"]     # most slots of a large-n window
BIG_CAP = _LIMITS["CS_BIG_CAP"]         # most records a block's reduce holds
MAX_WINDOWS = _LIMITS["CS_MAX_WINDOWS"]  # most windows of the large-n route
COARSE_MIN_N = 1 << 20     # from here on (32 MB of records) the large-n route
COARSE_WINDOWS = MAX_WINDOWS // 2  # windows it aims at: fine runs twice as long
FILL = BIG_CAP * 7 // 8    # most records of its mean window

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_N = ctypes.POINTER(ctypes.c_int)  # the launches an entry point enqueued
_SIGNATURES = {
    "cs_work_ints": ([_L, _L, _I], ctypes.c_longlong),
    "cs_small": ([_P, _P, _I, _L, _L, _I, _L, _I, _P, _P, _P, _I, _P, _N], ctypes.c_int),
    "cs_histogram": ([_P, _I, _L, _L, _I, _L, _I, _P, _P, _N], ctypes.c_int),
    "cs_scan": ([_L, _L, _P, _P, _N], ctypes.c_int),
    "cs_place": ([_P, _P, _I, _L, _L, _I, _L, _I, _I, _P, _P, _N], ctypes.c_int),
    "cs_reduce": ([_L, _L, _L, _I, _I, _I, _P, _P, _I, _P, _N], ctypes.c_int),
}
_FNS: dict[str, ctypes._CFuncPtr] = {}
_SMS: dict[int, int] = {}


def countsketch_clients_plain(x: torch.Tensor, h: torch.Tensor,
                              b: int) -> torch.Tensor:
    """Plain PyTorch segment sum of each row of ``x`` (G, n) over ``h``."""
    out = torch.zeros((x.shape[0], b), dtype=torch.float32, device=x.device)
    return out.index_add_(1, h, x.to(torch.float32))


def countsketch_clients_ordered(x: torch.Tensor, h: torch.Tensor,
                                b: int) -> torch.Tensor:
    """The Hopper route's sum order, in plain PyTorch: each slot summed from
    0.0 over its indices in ascending i, one float32 addition at a time, as
    a sequential loop would.  The route must match it bit for bit.  A
    reference for checks, not a route: it sorts h and takes one step per
    index of the longest slot.  An h outside [0, b) is dropped."""
    g, n = x.shape
    out = torch.zeros((g, b), dtype=torch.float32, device=x.device)
    keep = torch.nonzero((h >= 0) & (h < b)).flatten()
    if g == 0 or keep.numel() == 0:
        return out
    slots, at = torch.sort(h[keep].long(), stable=True)  # i ascending per slot
    idx = keep[at]
    step = torch.arange(len(idx), device=x.device) - torch.searchsorted(slots, slots)
    by_step = torch.sort(step, stable=True).indices    # the k-th index of every slot
    idx, slots = idx[by_step], slots[by_step]
    lo = 0
    for c in torch.bincount(step).tolist():           # a slot at most once a step
        i, j = idx[lo:lo + c], slots[lo:lo + c]
        out[:, j] = out[:, j] + x[:, i].to(torch.float32)
        lo += c
    return out


def route(n: int, b: int) -> tuple[int, bool]:
    """``(width, large)``: the slots per window (a power of two), and
    whether the large-n route runs (separate launches, records placed in
    two grouped passes, a block per window in the reduce).

    From ``COARSE_MIN_N`` indices on with n >= b (the uplink), windows are
    as narrow as keeps them at most ``COARSE_WINDOWS`` (~1,600 records each at
    the bert_100m uplink), so both passes write coalesced runs; narrower
    still, up to ``MAX_WINDOWS`` windows, while the mean window would hold
    more than ``FILL`` records, so that windows fit a block of the reduce.
    Otherwise the small-n route: 1 slot when n >= b; when b > n, the power
    of two at or above 16b/n, so a window holds 8-16 indices on average and
    there are at most ~n/16 windows, not b bins."""
    if n >= COARSE_MIN_N and n >= b:
        width = 1 << (-(-b // COARSE_WINDOWS) - 1).bit_length()
        while width > 1 and n * width > FILL * b and -(-b // (width // 2)) <= MAX_WINDOWS:
            width //= 2
        if width <= BIG_SLOTS:
            return width, True
    if n >= b:
        return 1, False
    return 1 << (-(-16 * b // max(n, 1)) - 1).bit_length(), False


def _fn(name: str) -> ctypes._CFuncPtr:
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(build.load("countsketch"), name)
        fn.argtypes, fn.restype = _SIGNATURES[name]
        _FNS[name] = fn
    return fn


def _call(name: str, *args) -> None:
    """Call the entry point ``name`` of the source and count the kernels
    and memsets it reports to have put on the stream."""
    launched = ctypes.c_int(0)
    err = _fn(name)(*args, ctypes.byref(launched))
    DEVICE_LAUNCHES.n += launched.value
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _mark(marks: list | None, stage: str) -> None:
    if marks is not None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((stage, ev))


def countsketch_clients_cuda(x: torch.Tensor, h: torch.Tensor, b: int, *,
                             marks: list | None = None) -> torch.Tensor:
    """The Hopper kernels' route: (G, n) float32 on CUDA -> (G, b).

    ``marks``, when a list, gets ``(stage, CUDA event)`` recorded before
    the first launch ("start") and after each stage: on the large-n route
    "histogram", "scan", then "placement" and "reduce" for each chunk of
    ``ROWS`` rows; on the small-n route, one launch, "route" and then
    ``("stamps", t)``, t the card's global timer in ns at the start, after
    the histogram, after the scan and after each chunk's placement and
    reduce.  So that the last stamp follows every block, a timed small-n
    call waits at one more grid barrier than an untimed one."""
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (G, n) float32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if h.dim() != 1 or h.shape[0] != x.shape[1] or not h.is_contiguous():
        raise ValueError(f"h must be contiguous (n,) = ({x.shape[1]},), got "
                         f"{tuple(h.shape)}")
    if h.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"h must be an integer tensor, got {h.dtype}")
    g, n = x.shape
    if n >= 1 << 31 or not 0 <= b < 1 << 31:
        raise ValueError("countsketch_clients_cuda indexes with int32: n, b < 2**31")
    if not (x.is_cuda and h.is_cuda and x.device == h.device):
        raise ValueError("countsketch_clients_cuda needs x and h on one CUDA device")
    out = torch.empty((g, b), dtype=torch.float32, device=x.device)
    if g == 0:
        return out
    width, large = route(n, b)
    (large_route if large else small_route)(x, h, b, width, out, marks)
    LAUNCHES.n += 1
    return out


def work_ints(n: int, nbins: int, coarse: bool) -> int:
    """The int32 scratch a call holds while it runs: ``layout`` of the
    source (``cs_work_ints``), each array from 16 bytes on."""
    cap, scan, buckets = _LIMITS["CS_CAP"], _LIMITS["CS_SCAN"], _LIMITS["CS_BUCKETS"]
    p = 0
    for ints in (8 * n, 8 * n if coarse else 0, n, n // (cap + 1) + 1, nbins,
                 nbins + 1, -(-nbins // scan), 2, nbins, 1, buckets,
                 n // (cap + 1) + 1):
        p = ((p + 3) & ~3) + ints
    return p


def _setup(x: torch.Tensor, h: torch.Tensor, b: int, width: int, large: bool):
    """(shift, nbins, h64, SMs, stream, scratch) of a call."""
    nbins = -(-b // width)
    dev = x.device.index
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    # one int32 scratch buffer, laid out by the source: records, counts,
    # offsets, cursors and the long windows' list and order
    scratch = torch.empty(_fn("cs_work_ints")(x.shape[1], nbins, int(large)),
                          dtype=torch.int32, device=x.device)
    return (width.bit_length() - 1, nbins, int(h.dtype == torch.int64), _SMS[dev],
            torch.cuda.current_stream(x.device).cuda_stream, scratch)


def small_route(x: torch.Tensor, h: torch.Tensor, b: int, width: int,
                out: torch.Tensor, marks: list | None = None) -> None:
    """The small-n route's launches (one cooperative kernel and a memset)
    at ``width`` slots a window, into ``out`` (G, b), G > 0."""
    shift, nbins, h64, sms, stream, scratch = _setup(x, h, b, width, False)
    g, n = x.shape
    _mark(marks, "start")
    # one launch; its stages are timed by the card's global timer
    stamps = (None if marks is None else
              torch.empty(3 + 2 * -(-g // ROWS), dtype=torch.int64, device=x.device))
    _call("cs_small", x.data_ptr(), h.data_ptr(), h64, n, b, shift, nbins, g,
          scratch.data_ptr(), out.data_ptr(),
          None if stamps is None else stamps.data_ptr(), sms, stream)
    _mark(marks, "route")
    if marks is not None:
        marks.append(("stamps", stamps))


def large_route(x: torch.Tensor, h: torch.Tensor, b: int, width: int,
                out: torch.Tensor, marks: list | None = None) -> None:
    """The large-n route's launches at ``width`` (at most ``BIG_SLOTS``)
    slots a window, into ``out`` (G, b), G > 0."""
    shift, nbins, h64, sms, stream, scratch = _setup(x, h, b, width, True)
    g, n = x.shape
    work = scratch.data_ptr()
    _mark(marks, "start")
    _call("cs_histogram", h.data_ptr(), h64, n, b, shift, nbins, sms, work, stream)
    _mark(marks, "histogram")
    _call("cs_scan", n, nbins, work, stream)
    _mark(marks, "scan")
    for g0 in range(0, g, ROWS):
        rows = min(ROWS, g - g0)
        _call("cs_place", x.data_ptr(), h.data_ptr(), h64, n, b, shift, nbins,
              g0, rows, work, stream)
        _mark(marks, "placement")
        _call("cs_reduce", n, nbins, b, shift, g0, rows, work, out.data_ptr(),
              2 * sms, stream)
        _mark(marks, "reduce")
