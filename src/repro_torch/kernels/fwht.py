"""Unnormalized fast Walsh-Hadamard transform along the last axis.

Counterpart of ``repro/kernels/fwht.py``.

* ``fwht_plain`` -- the plain PyTorch version: the reshape butterfly of
  the reference's ``core/sketch.py::fwht``, for any power-of-two length.
  It is the kernel's oracle, what runs on the CPU, and the plain ``fwht``
  of ``repro_torch.core.sketch``.
* ``fwht_rows_cuda`` -- the hand-written Hopper kernels
  (``csrc/fwht.cu``): one shared-memory pass for rows up to ``MAX_C``;
  longer rows, up to ``MAX_C ** 2``, as the reference's two-level
  Kronecker split (``fwht_rows`` along rows of length ``MAX_C``, then
  ``fwht_cols`` across them), batched over all rows in two launches.

``LAUNCHES.n`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

MAX_C = 4096           # longest row one shared-memory pass transforms
MAX_N = MAX_C * MAX_C  # longest row the two-pass Kronecker path transforms

LAUNCHES = build.LaunchCount()


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


def _launch(fn_name: str, argtypes, *args) -> None:
    fn = getattr(build.load("fwht"), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err}")
    LAUNCHES.n += 1


def fwht_rows_cuda(x: torch.Tensor) -> torch.Tensor:
    """The Hopper kernels' route: FWHT of each row of (R, C) float32 on
    CUDA, C a power of two <= ``MAX_N``."""
    if not x.is_cuda:
        raise ValueError("fwht_rows_cuda needs a CUDA tensor")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (R, C) float32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    r, c = x.shape
    if c & (c - 1) or c > MAX_N:
        raise ValueError(f"row length {c} must be a power of 2 <= {MAX_N}")
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    if c <= MAX_C:
        _launch("fwht_rows", [vp, vp, ll, i, vp],
                x.data_ptr(), out.data_ptr(), r, c, stream)
        return out
    n1 = c // MAX_C           # H_c = H_n1 (x) H_MAX_C on x.reshape(r, n1, MAX_C)
    _launch("fwht_rows", [vp, vp, ll, i, vp],
            x.data_ptr(), out.data_ptr(), r * n1, MAX_C, stream)
    _launch("fwht_cols", [vp, vp, ll, i, i, vp],
            out.data_ptr(), out.data_ptr(), r, n1, MAX_C, stream)
    return out
