"""Dispatch around the four kernels, in the serving model's layouts.

``mode="auto"``: each kernel wrapper runs its CUDA kernel for CUDA tensors
and its plain version for CPU tensors.  ``mode="plain"``: the plain version
on any device (the on-card reference the kernels are held against).
Matmuls take x (..., K) and a :class:`QTensor`; attention takes q in the
model's (B, T, Hq, D) layout and the cache tuple as stored.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.qtensor import QTensor
from repro_torch.kernels import dequant_matmul as dq
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import flash_prefill as fp
from repro_torch.kernels import int8_matmul as i8

MODES = ("auto", "plain")
DEFAULT_BLOCK_KV = 512   # plain-version tile, clamped to S like the reference


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode={mode!r}: use one of {MODES}")


def _rows(x: torch.Tensor, qt: QTensor):
    """(..., K) -> (M, K) contiguous, the lead shape, and an empty-M result
    (zero rows give a zero-row output without a launch)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    empty = None
    if x2.shape[0] == 0:
        empty = torch.zeros((*lead, qt.d_out), dtype=x.dtype, device=x.device)
    return x2, lead, empty


def dequant_matmul(x: torch.Tensor, qt: QTensor, *, mode: str = "auto"):
    """y = x @ dequant(qt), x (..., K) -> (..., N)."""
    _check_mode(mode)
    x2, lead, empty = _rows(x, qt)
    if empty is not None:
        return empty
    fn = dq.dequant_matmul_plain if mode == "plain" else dq.dequant_matmul
    out = fn(x2, qt.packed, qt.scale, qt.zp, bits=qt.bits,
             group_size=qt.group_size)
    return out.reshape(*lead, out.shape[-1])


def quant_matmul(x: torch.Tensor, qt: QTensor, *, a_bits: int,
                 mode: str = "auto"):
    """y = dyn_quant(x, a_bits) @ dequant(qt); ``a_bits >= 16`` is the
    weight-only path."""
    _check_mode(mode)
    if a_bits >= 16:
        return dequant_matmul(x, qt, mode=mode)
    if not 2 <= a_bits <= 8:
        raise ValueError(f"a_bits={a_bits} unsupported: use 2..8 (int8 "
                         f"lanes) or >= 16 (float activations)")
    x2, lead, empty = _rows(x, qt)
    if empty is not None:
        return empty
    fn = i8.quant_matmul_plain if mode == "plain" else i8.w4a8_matmul
    out = fn(x2, qt.packed, qt.scale, qt.zp, bits=qt.bits,
             group_size=qt.group_size, a_bits=a_bits)
    return out.reshape(*lead, out.shape[-1])


def _unpack_kv(kv):
    if len(kv) == 4:
        return kv
    if len(kv) == 2:
        return kv[0], kv[1], None, None
    raise TypeError(f"kv must be (k, v) or (k, v, k_scale, v_scale), got "
                    f"{len(kv)} entries")


def _block(s: int, block_kv: Optional[int]) -> int:
    bkv = block_kv or DEFAULT_BLOCK_KV
    return s if bkv > s or s % bkv else bkv


def flash_decode(q, kv, cur_len, *, scale: Optional[float] = None,
                 block_kv: Optional[int] = None, mode: str = "auto"):
    """q (B, 1, Hq, D), cache tuple as stored, cur_len (B,) valid positions
    (the just-written token included) -> (B, 1, Hq, D)."""
    _check_mode(mode)
    k, v, k_scale, v_scale = _unpack_kv(kv)
    b, t, hq, d = q.shape
    if t != 1:
        raise ValueError(f"flash_decode is a one-token kernel; got T={t}")
    s, hkv = k.shape[1], k.shape[2]
    q4 = q.reshape(b, hkv, hq // hkv, d).contiguous()
    fn = fd.flash_decode_plain if mode == "plain" else fd.flash_decode
    out = fn(q4, k, v, cur_len, k_scale, v_scale, scale=scale,
             block_kv=_block(s, block_kv))
    return out.reshape(b, 1, hq, d)


def flash_prefill(q, kv, offset, chunk_len, *, scale: Optional[float] = None,
                  block_kv: Optional[int] = None, mode: str = "auto"):
    """q (B, C, Hq, D) chunk at ``offset``, cache tuple as stored (chunk
    K/V already written), chunk_len (B,) valid rows -> (B, C, Hq, D)."""
    _check_mode(mode)
    k, v, k_scale, v_scale = _unpack_kv(kv)
    b, c, hq, d = q.shape
    if c < 1:
        raise ValueError(f"flash_prefill needs a non-empty chunk; got C={c}")
    s, hkv = k.shape[1], k.shape[2]
    q5 = q.reshape(b, c, hkv, hq // hkv, d).transpose(1, 2).contiguous()
    fn = fp.flash_prefill_plain if mode == "plain" else fp.flash_prefill
    out = fn(q5, k, v, offset, chunk_len, k_scale, v_scale, scale=scale,
             block_kv=_block(s, block_kv))
    return out.transpose(1, 2).reshape(b, c, hq, d)
