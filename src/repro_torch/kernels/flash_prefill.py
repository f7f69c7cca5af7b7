"""Chunked causal prefill attention over the KV cache as stored, linear or
paged.

``flash_prefill_plain`` and ``flash_prefill_paged_plain`` are the plain
PyTorch versions of the reference's tile-structured ``flash_prefill_ref``
and ``flash_prefill_paged_ref``; ``flash_prefill`` and
``flash_prefill_paged`` run them for CPU tensors and launch
``csrc/flash_prefill.cu`` for CUDA tensors.

Layouts: q (B, Hkv, C, G, D) — chunk token ``c`` at position
``offset[b] + c``; the cache (linear or paged, kv16/kv8/kv4) as in
:mod:`repro_torch.kernels.flash_decode`, with the chunk's own K/V already
written; offset, chunk_len (B,) int32.  Position ``p`` is valid for row
``c`` iff ``p <= offset + c`` and ``c < chunk_len``; pad rows are zeros.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.flash_decode import (attend_plain, cache_tiles,
                                              check_cache, check_page_table)


def _prefill_plain(q, tiles, offset, chunk_len, scale):
    bsz, hkv, c, g, d = q.shape
    r = c * g
    scale = scale if scale is not None else d ** -0.5
    off = offset.to(torch.int32)[:, None, None, None]
    cl = chunk_len.to(torch.int32)[:, None, None, None]
    # chunk_len == 0 sequences visit no tiles: state stays at init and the
    # row mask zeroes them
    total = torch.where(cl > 0, off + cl, 0)
    row_tok = (torch.arange(r, device=q.device) // g)[None, None, :, None]
    out = attend_plain(
        q.to(torch.float32).reshape(bsz, hkv, r, d), tiles, scale,
        lambda pos: (pos <= off + row_tok) & (row_tok < cl),
        lambda start: start < total)
    out = torch.where(row_tok < cl, out, 0.0)
    return out.reshape(bsz, hkv, c, g, d).to(q.dtype)


def flash_prefill_plain(q, k, v, offset, chunk_len, k_scale=None,
                        v_scale=None, *, scale: Optional[float] = None,
                        block_kv: int = 128):
    return _prefill_plain(q, cache_tiles(k, v, k_scale, v_scale,
                                         block_kv=block_kv),
                          offset, chunk_len, scale)


def flash_prefill_paged_plain(q, k_pool, v_pool, page_table, offset,
                              chunk_len, k_scale=None, v_scale=None, *,
                              scale: Optional[float] = None):
    return _prefill_plain(q, cache_tiles(k_pool, v_pool, k_scale, v_scale,
                                         page_table=page_table),
                          offset, chunk_len, scale)


def _rows_args(q, offset, chunk_len):
    offset = offset.to(device=q.device, dtype=torch.int32).contiguous()
    chunk_len = chunk_len.to(device=q.device, dtype=torch.int32).contiguous()
    return offset, chunk_len, torch.empty_like(q)


def flash_prefill(q, k, v, offset, chunk_len, k_scale=None, v_scale=None, *,
                  scale: Optional[float] = None, block_kv: int = 128):
    """Plain version (tiles of ``block_kv``) for CPU tensors, the CUDA
    kernel (its own tiling) for CUDA tensors."""
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, offset, chunk_len, k_scale,
                                   v_scale, scale=scale, block_kv=block_kv)
    bsz, hkv, c, g, d = q.shape
    s = k.shape[1]
    bits = check_cache("flash_prefill", q, k, v, k_scale, v_scale)
    if k.shape[:3] != (bsz, s, hkv):
        raise ValueError(f"flash_prefill: cache {tuple(k.shape)} does not "
                         f"match q {tuple(q.shape)}")
    offset, chunk_len, out = _rows_args(q, offset, chunk_len)
    scale = scale if scale is not None else d ** -0.5
    _lib.launch("flash_prefill", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                _lib.ptr(k_scale), _lib.ptr(v_scale), offset.data_ptr(),
                chunk_len.data_ptr(), out.data_ptr(), bsz, s, hkv, c, g, d,
                float(scale), bits)
    return out


def flash_prefill_paged(q, k_pool, v_pool, page_table, offset, chunk_len,
                        k_scale=None, v_scale=None, *,
                        scale: Optional[float] = None):
    """Plain version (one page per tile) for CPU tensors, the CUDA kernel
    (tiles of 32 positions, each position's page looked up) for CUDA
    tensors."""
    if q.device.type == "cpu":
        return flash_prefill_paged_plain(q, k_pool, v_pool, page_table,
                                         offset, chunk_len, k_scale, v_scale,
                                         scale=scale)
    bsz, hkv, c, g, d = q.shape
    bits = check_cache("flash_prefill_paged", q, k_pool, v_pool, k_scale,
                       v_scale)
    if k_pool.shape[2] != hkv:
        raise ValueError(f"flash_prefill_paged: pool {tuple(k_pool.shape)} "
                         f"does not match q {tuple(q.shape)}")
    pt = check_page_table("flash_prefill_paged", page_table, bsz, q.device)
    offset, chunk_len, out = _rows_args(q, offset, chunk_len)
    scale = scale if scale is not None else d ** -0.5
    _lib.launch("flash_prefill_paged", q.data_ptr(), k_pool.data_ptr(),
                v_pool.data_ptr(), _lib.ptr(k_scale), _lib.ptr(v_scale),
                pt.data_ptr(), offset.data_ptr(), chunk_len.data_ptr(),
                out.data_ptr(), bsz, k_pool.shape[1], pt.shape[1], hkv, c, g,
                d, float(scale), bits)
    return out
