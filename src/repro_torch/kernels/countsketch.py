"""Batched count-sketch segment sum: ``out[g, j] = sum_{h[i] == j} x[g, i]``.

Counterpart of ``repro/kernels/countsketch.py``.  ``x`` is ``(G, n)``
float32, already multiplied by the signs; ``h`` is ``(n,)`` in ``[0, b)``
and shared by all G rows (one sketch operator per round).

* ``countsketch_clients_plain`` -- the plain PyTorch version
  (``zeros((G, b)).index_add_``), the oracle of the kernel and what runs on
  the CPU.  On CUDA, ``index_add_`` adds repeated indices with atomics in
  no fixed order, which is why it is not the card's route.
* ``countsketch_clients_cuda`` -- the hand-written Hopper kernel
  (``csrc/countsketch.cu``): the wrapper buckets ``h`` into CSR form with
  ``torch.sort(stable=True)``, ``torch.bincount`` and ``torch.cumsum``,
  and the kernel sums each slot's segment in ascending index order, so the
  result is deterministic.

``LAUNCHES.n`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

LAUNCHES = build.LaunchCount()


def countsketch_clients_plain(x: torch.Tensor, h: torch.Tensor,
                              b: int) -> torch.Tensor:
    """Plain PyTorch segment sum of each row of ``x`` (G, n) over ``h``."""
    out = torch.zeros((x.shape[0], b), dtype=torch.float32, device=x.device)
    return out.index_add_(1, h, x.to(torch.float32))


def bucket(h: torch.Tensor, b: int) -> tuple[torch.Tensor, torch.Tensor]:
    """CSR form of the hash: ``perm`` lists the indices i in order of
    ``(h[i], i)`` and slot j owns ``perm[off[j]:off[j + 1]]``."""
    perm = torch.sort(h, stable=True).indices.to(torch.int32)
    off = torch.zeros(b + 1, dtype=torch.int32, device=h.device)
    off[1:] = torch.cumsum(torch.bincount(h, minlength=b), 0)
    return perm, off


def countsketch_clients_cuda(x: torch.Tensor, h: torch.Tensor,
                             b: int) -> torch.Tensor:
    """The Hopper kernel's route: (G, n) float32 on CUDA -> (G, b)."""
    if not (x.is_cuda and h.is_cuda and x.device == h.device):
        raise ValueError("countsketch_clients_cuda needs x and h on one CUDA device")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (G, n) float32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if h.dim() != 1 or h.shape[0] != x.shape[1]:
        raise ValueError(f"h must be (n,) = ({x.shape[1]},), got {tuple(h.shape)}")
    if h.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"h must be an integer tensor, got {h.dtype}")
    g, n = x.shape
    if n >= 1 << 31:
        raise ValueError("countsketch_clients_cuda indexes with int32: n < 2**31")
    perm, off = bucket(h, b)
    out = torch.empty((g, b), dtype=torch.float32, device=x.device)
    return segsum(x, perm, off, out)


def segsum(x: torch.Tensor, perm: torch.Tensor, off: torch.Tensor,
           out: torch.Tensor) -> torch.Tensor:
    """Launch the segment-sum kernel on bucketed indices into ``out``
    (G, b); the caller has checked the shapes (``countsketch_clients_cuda``)."""
    g, n = x.shape
    fn = build.load("countsketch").countsketch_segsum
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong,
                                           ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), perm.data_ptr(), off.data_ptr(), out.data_ptr(),
             g, n, out.shape[1], torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"countsketch_segsum launch failed: CUDA error {err}")
    LAUNCHES.n += 1
    return out
