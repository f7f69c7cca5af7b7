"""Dispatch around the kernels, in the serving model's layouts.

``mode="auto"``: each kernel wrapper runs its CUDA kernel for CUDA tensors
and its plain version for CPU tensors.  ``mode="plain"``: the plain version
on any device (the on-card reference the kernels are held against).
Matmuls take x (..., K) and a :class:`QTensor` (``w8a8_matmul``: int8
codes and per-channel scales); attention takes q in the model's
(B, T, Hq, D) layout and the cache tuple as stored (linear, or page pools
with a ``page_table``).  3-bit weights are a storage format the kernels do
not unpack: the packed matmuls and ``quantize_pack`` send them to their
plain versions on every device, as the reference sends them to its ref
math.  The pre-quantized ``int8_matmul`` has no wrapper here (nor in the
reference): call :func:`repro_torch.kernels.int8_matmul.int8_matmul`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.qtensor import QTensor
from repro_torch.kernels import dequant_matmul as dq
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import flash_prefill as fp
from repro_torch.kernels import int8_matmul as i8
from repro_torch.kernels import quantize_pack as qp

MODES = ("auto", "plain")
DEFAULT_BLOCK_KV = 512   # plain-version tile, clamped to S like the reference


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode={mode!r}: use one of {MODES}")


def _rows(x: torch.Tensor, d_out: int):
    """(..., K) -> (M, K) contiguous, the lead shape, and an empty-M result
    (zero rows give a zero-row output without a launch)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    empty = None
    if x2.shape[0] == 0:
        empty = torch.zeros((*lead, d_out), dtype=x.dtype, device=x.device)
    return x2, lead, empty


def dequant_matmul(x: torch.Tensor, qt: QTensor, *, mode: str = "auto"):
    """y = x @ dequant(qt), x (..., K) -> (..., N)."""
    _check_mode(mode)
    x2, lead, empty = _rows(x, qt.d_out)
    if empty is not None:
        return empty
    plain = mode == "plain" or qt.bits == 3
    fn = dq.dequant_matmul_plain if plain else dq.dequant_matmul
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
    x2, lead, empty = _rows(x, qt.d_out)
    if empty is not None:
        return empty
    plain = mode == "plain" or qt.bits == 3
    fn = i8.quant_matmul_plain if plain else i8.w4a8_matmul
    out = fn(x2, qt.packed, qt.scale, qt.zp, bits=qt.bits,
             group_size=qt.group_size, a_bits=a_bits)
    return out.reshape(*lead, out.shape[-1])


def w8a8_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                *, mode: str = "auto"):
    """y = dyn_quant8(x) @ w_q * w_scale, x (..., K), w_q (K, N) int8,
    w_scale (N,) -> (..., N) in x.dtype; one whole-row activation scale."""
    _check_mode(mode)
    x2, lead, empty = _rows(x, w_q.shape[-1])
    if empty is not None:
        return empty
    fn = i8.w8a8_dynamic_plain if mode == "plain" else i8.w8a8_matmul
    out = fn(x2, w_q, w_scale)
    return out.reshape(*lead, out.shape[-1])


def quantize_pack(w: torch.Tensor, *, bits: int, group_size: int,
                  mode: str = "auto"):
    """w (K, N) float, or a (B, K, N) stack -> (packed, scale, zp),
    per-group asymmetric RTN codes packed along K; ``group_size`` 0 is one
    K-wide group.  A stack is one kernel launch."""
    _check_mode(mode)
    if mode == "plain" or bits == 3:
        return qp.quantize_pack_plain_batch(w, bits, group_size)
    return qp.quantize_pack(w, bits=bits, group_size=group_size)


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


def _paged_shapes(q, k, k_scale, page_table) -> None:
    """The reference's shape checks of the paged route: pools
    (P, page_size, Hkv, Dk), a (B, max_pages) page table."""
    b, d = q.shape[0], q.shape[-1]
    packed = fd.kv_bits_of(k, k_scale) == 4
    dk = d // 2 if packed else d
    if k.ndim != 4 or k.shape[-1] != dk:
        raise ValueError(f"paged kv pools must be (P, page_size, Hkv, "
                         f"{'D//2 packed' if packed else 'D'}); got "
                         f"{tuple(k.shape)}")
    if page_table.ndim != 2 or page_table.shape[0] != b:
        raise ValueError(f"page_table must be (B, max_pages_per_seq); got "
                         f"{tuple(page_table.shape)} for B={b}")


def flash_decode(q, kv, cur_len, *, scale: Optional[float] = None,
                 block_kv: Optional[int] = None, page_table=None,
                 mode: str = "auto"):
    """q (B, 1, Hq, D), cache tuple as stored, cur_len (B,) valid positions
    (the just-written token included) -> (B, 1, Hq, D).  With
    ``page_table`` (B, max_pages) the cache entries are page pools
    (P, page_size, Hkv, Dk) and ``block_kv`` is ignored."""
    _check_mode(mode)
    k, v, k_scale, v_scale = _unpack_kv(kv)
    b, t, hq, d = q.shape
    if t != 1:
        raise ValueError(f"flash_decode is a one-token kernel; got T={t}")
    hkv = k.shape[2]
    q4 = q.reshape(b, hkv, hq // hkv, d).contiguous()
    if page_table is not None:
        _paged_shapes(q, k, k_scale, page_table)
        fn = (fd.flash_decode_paged_plain if mode == "plain"
              else fd.flash_decode_paged)
        out = fn(q4, k, v, page_table, cur_len, k_scale, v_scale,
                 scale=scale)
    else:
        fn = fd.flash_decode_plain if mode == "plain" else fd.flash_decode
        out = fn(q4, k, v, cur_len, k_scale, v_scale, scale=scale,
                 block_kv=_block(k.shape[1], block_kv))
    return out.reshape(b, 1, hq, d)


def flash_prefill(q, kv, offset, chunk_len, *, scale: Optional[float] = None,
                  block_kv: Optional[int] = None, page_table=None,
                  mode: str = "auto"):
    """q (B, C, Hq, D) chunk at ``offset``, cache tuple as stored (chunk
    K/V already written), chunk_len (B,) valid rows -> (B, C, Hq, D).
    With ``page_table`` the cache entries are page pools, as in
    :func:`flash_decode`."""
    _check_mode(mode)
    k, v, k_scale, v_scale = _unpack_kv(kv)
    b, c, hq, d = q.shape
    if c < 1:
        raise ValueError(f"flash_prefill needs a non-empty chunk; got C={c}")
    hkv = k.shape[2]
    q5 = q.reshape(b, c, hkv, hq // hkv, d).transpose(1, 2).contiguous()
    if page_table is not None:
        _paged_shapes(q, k, k_scale, page_table)
        fn = (fp.flash_prefill_paged_plain if mode == "plain"
              else fp.flash_prefill_paged)
        out = fn(q5, k, v, page_table, offset, chunk_len, k_scale, v_scale,
                 scale=scale)
    else:
        fn = fp.flash_prefill_plain if mode == "plain" else fp.flash_prefill
        out = fn(q5, k, v, offset, chunk_len, k_scale, v_scale, scale=scale,
                 block_kv=_block(k.shape[1], block_kv))
    return out.transpose(1, 2).reshape(b, c, hq, d)
