"""Sub-byte integer packing for deployed quantized weights.

Layout (identical bytes to the reference): groups of 8 consecutive values
along the input-channel axis K are packed little-endian into ``bits``
bytes, so value ``j`` of a group sits at bits ``j*bits .. j*bits+bits-1``
of a 64-bit lane.  A (K, N) code matrix packs to (K // 8 * bits, N) uint8;
leading dims (stacked layers) pass through.
"""
from __future__ import annotations

import torch

PACK_GROUP = 8  # values per packing unit


def packed_rows(d_in: int, bits: int) -> int:
    """Number of packed uint8 rows for ``d_in`` unpacked rows."""
    if d_in % PACK_GROUP != 0:
        raise ValueError(f"d_in={d_in} must be a multiple of {PACK_GROUP}")
    return d_in // PACK_GROUP * bits


def pack(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack uint8 codes (..., d_in, d_out), values < 2**bits, into bytes.

    Returns (..., d_in // 8 * bits, d_out) uint8."""
    if not 1 <= bits <= 8:
        raise ValueError(f"bits must be in [1, 8], got {bits}")
    lead, (d_in, d_out) = codes.shape[:-2], codes.shape[-2:]
    if d_in % PACK_GROUP != 0:
        raise ValueError(f"d_in={d_in} must be a multiple of {PACK_GROUP}")
    c = codes.to(torch.int64).reshape(
        *lead, d_in // PACK_GROUP, PACK_GROUP, d_out)
    lane = torch.zeros(*lead, d_in // PACK_GROUP, d_out, dtype=torch.int64,
                       device=codes.device)
    for j in range(PACK_GROUP):
        lane |= c[..., j, :] << (j * bits)
    out = [((lane >> (8 * b)) & 0xFF).to(torch.uint8) for b in range(bits)]
    packed = torch.stack(out, dim=-2)     # (..., d_in//8, bits, d_out)
    return packed.reshape(*lead, d_in // PACK_GROUP * bits, d_out)


def unpack(packed: torch.Tensor, bits: int, d_in: int) -> torch.Tensor:
    """Inverse of :func:`pack`.  Returns uint8 codes (..., d_in, d_out)."""
    if not 1 <= bits <= 8:
        raise ValueError(f"bits must be in [1, 8], got {bits}")
    n_units = d_in // PACK_GROUP
    lead, d_out = packed.shape[:-2], packed.shape[-1]
    p = packed.reshape(*lead, n_units, bits, d_out).to(torch.int64)
    lane = torch.zeros(*lead, n_units, d_out, dtype=torch.int64,
                       device=packed.device)
    for b in range(bits):
        lane |= p[..., b, :] << (8 * b)
    mask = (1 << bits) - 1
    vals = [(lane >> (j * bits)) & mask for j in range(PACK_GROUP)]
    codes = torch.stack(vals, dim=-2)     # (..., n_units, 8, d_out)
    return codes.reshape(*lead, d_in, d_out).to(torch.uint8)


def pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """Pack signed int4 codes (values in [-8, 7]) two per byte along the
    last axis: (..., D) -> (..., D // 2) int8.  Byte ``j`` holds value
    ``2j`` in its low nibble and value ``2j + 1`` in its high nibble (the
    kv4 cache layout)."""
    d = codes.shape[-1]
    if d % 2 != 0:
        raise ValueError(f"pack_nibbles needs an even last axis (two codes "
                         f"per byte); got D={d}")
    c = codes.to(torch.int32) & 0xF
    return (c[..., 0::2] | (c[..., 1::2] << 4)).to(torch.int8)


def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_nibbles`: (..., D // 2) int8 -> (..., D)
    int32, sign-extended back to [-8, 7] (``<< 28 >> 28`` for the low
    nibble, ``>> 4`` for the high one)."""
    xi = packed.to(torch.int32)
    lo = (xi << 28) >> 28
    hi = xi >> 4
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1],
                                                 packed.shape[-1] * 2)
