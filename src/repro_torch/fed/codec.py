"""Quantized sketch payload codec: real bits on the wire.

Counterpart of ``repro/fed/codec.py``.  The codec sits between the fused
sketch and the guard:

    delta --sk--> (b_total,) row --[+EF]--> quantize --> dequantize
          --> faults/sentinels/mask --> the one masked mean

* **int8** (``bits=8``): per-row scale ``s = max|row| / 127``, stochastic
  rounding ``q = clip(floor(row / s + u), -127, 127)``, decode ``q * s``;
* **1-bit** (``bits=1``): ``s = max|row|``, ``+s`` with probability
  ``(row / s + 1) / 2``, else ``-s``;
* **error feedback**: the residual ``e' = (x + e) - Q(x + e)`` is kept per
  client in sketch space, a ``(G, b_total)`` memory beside the server's
  state, and added before the next quantization.

The payload stays a float32 tensor holding exactly what the wire format
decodes to; the measured wire size is ``CodecConfig.payload_bits``.  The
rounding uniforms of a row are ``uniform(fold_in(fold_in(fold_in(
round_key, 15485863), seed), c), (b,))`` for its GLOBAL client index c,
the reference's stream bit for bit, so a streamed chunk draws the
uniforms the materialized cohort draws.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.safl import mask_weights

# decorrelates the rounding stream from the data sampler, fault (104729)
# and delay (7919) fold_in chains
_CODEC_STREAM_TAG = 15485863


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """``bits`` per payload coordinate, 8 (int8) or 1 (sign);
    ``error_feedback`` keeps the per-client residual across rounds (the
    round state is then ``{"opt": ..., "ef": (G, b_total)}``, see
    ``init_codec_state``); ``seed`` decorrelates the rounding uniforms."""
    bits: int = 8
    error_feedback: bool = True
    seed: int = 0

    def __post_init__(self):
        if self.bits not in (1, 8):
            raise ValueError(f"bits must be 1 or 8, got {self.bits}")

    def payload_bits(self, b_total: int) -> int:
        """Measured bits of one encoded row: ``bits`` a coordinate plus one
        float32 scale."""
        return int(b_total) * self.bits + 32


def init_codec_state(codec: Optional[CodecConfig], num_clients: int,
                     b_total: int, device="cuda") -> Optional[torch.Tensor]:
    """The ``(G, b_total)`` error-feedback memory (zeros), or ``None`` when
    the codec is off or keeps no memory."""
    if codec is None or not codec.error_feedback:
        return None
    return torch.zeros((num_clients, b_total), dtype=torch.float32,
                       device=device)


def _row_key(codec: CodecConfig, round_key: prng.Key, client_id: int) -> prng.Key:
    k = prng.fold_in(round_key, _CODEC_STREAM_TAG)
    k = prng.fold_in(k, codec.seed)
    return prng.fold_in(k, int(client_id))


def _quantize_row(codec: CodecConfig, u: torch.Tensor,
                  row: torch.Tensor) -> torch.Tensor:
    """Quantize-dequantize rows (last axis) with their uniforms ``u``.  An
    all-zero row has scale 0 and decodes to exactly 0: the selects keep
    0/0 out of the arithmetic."""
    if codec.bits == 1:
        s = torch.amax(torch.abs(row), dim=-1, keepdim=True)
        p = torch.where(s > 0, (row / torch.where(s > 0, s, 1.0) + 1.0) * 0.5,
                        0.5)
        return torch.where(u < p, 1.0, -1.0) * s
    lim = float(2 ** (codec.bits - 1) - 1)                 # 127 for int8
    # ``max / 127`` as the reference's compiled round computes it: XLA
    # turns a division by a constant into a multiply by its float32
    # reciprocal, which rounds differently
    s = torch.amax(torch.abs(row), dim=-1, keepdim=True) * float(
        np.float32(1.0) / np.float32(lim))
    scaled = torch.where(s > 0, row / torch.where(s > 0, s, 1.0), 0.0)
    q = torch.clamp(torch.floor(scaled + u), -lim, lim)
    return q * s


def quantize_rows(codec: CodecConfig, round_key: prng.Key, rows: torch.Tensor,
                  client_ids: Sequence[int]) -> torch.Tensor:
    """Quantize-dequantize ``(n, b)`` rows; ``client_ids`` are the rows'
    global client indices."""
    keys = [_row_key(codec, round_key, c) for c in client_ids]
    u = prng.uniform_many(keys, (rows.shape[-1],), rows.device)
    return _quantize_row(codec, u, rows)


def encode_decode(codec: CodecConfig, round_key: prng.Key, rows: torch.Tensor,
                  ef_rows: Optional[torch.Tensor] = None,
                  client_ids: Optional[Sequence[int]] = None):
    """The round's codec stage on ``(n, b)`` rows: ``x = rows + ef``, the
    decoded ``Q(x)`` and the new residual ``x - Q(x)`` (``None`` without
    ``ef_rows``).  The fold sums decoded rows, so sketch linearity still
    carries the streamed fold."""
    if client_ids is None:
        client_ids = range(rows.shape[0])
    x = rows if ef_rows is None else rows + ef_rows
    dec = quantize_rows(codec, round_key, x, client_ids)
    return dec, (x - dec) if ef_rows is not None else None


def transmitting_clients(mask) -> torch.Tensor:
    """Clients billed: strictly positive weight in the effective
    (post-guard) mask, as float32."""
    return torch.sum((mask_weights(mask) > 0).to(torch.float32))


def measured_uplink_bits(codec: CodecConfig, b_total: int, eff_mask=None,
                         num_clients: Optional[int] = None, device="cuda"):
    """A codec round's measured uplink bits (float32): the encoded row's
    size times the effective transmitting cohort (``eff_mask=None``: all
    ``num_clients``, on ``device``)."""
    if eff_mask is not None:
        device = mask_weights(eff_mask).device
    per_client = torch.tensor(float(codec.payload_bits(b_total)),
                              dtype=torch.float32, device=device)
    if eff_mask is None:
        return per_client * float(num_clients)
    return per_client * transmitting_clients(eff_mask)
