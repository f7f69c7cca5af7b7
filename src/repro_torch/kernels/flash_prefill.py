"""Chunked causal prefill attention over the linear cache as stored.

``flash_prefill_plain`` is the plain PyTorch version of the reference's
tile-structured ``flash_prefill_ref``; ``flash_prefill`` runs it for CPU
tensors and launches ``csrc/flash_prefill.cu`` for CUDA tensors.

Layouts: q (B, Hkv, C, G, D) — chunk token ``c`` at position
``offset[b] + c``; k/v (B, S, Hkv, D) as in
:mod:`repro_torch.kernels.flash_decode`, with the chunk's own K/V already
written; offset, chunk_len (B,) int32.  Position ``p`` is valid for row
``c`` iff ``p <= offset + c`` and ``c < chunk_len``; pad rows are zeros.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.flash_decode import MASK, check_cache, dequant_tile


def flash_prefill_plain(q, k, v, offset, chunk_len, k_scale=None,
                        v_scale=None, *, scale: Optional[float] = None,
                        block_kv: int = 128):
    bsz, hkv, c, g, d = q.shape
    s = k.shape[1]
    if s % block_kv:
        raise ValueError(f"S={s} is not a multiple of block_kv={block_kv}")
    r = c * g
    dev = q.device
    scale = scale if scale is not None else d ** -0.5
    off = offset.to(torch.int32)[:, None, None, None]
    cl = chunk_len.to(torch.int32)[:, None, None, None]
    # chunk_len == 0 sequences visit no tiles: state stays at init and the
    # row mask zeroes them
    total = torch.where(cl > 0, off + cl, 0)
    qf = q.to(torch.float32).reshape(bsz, hkv, r, d)
    row_tok = (torch.arange(r, device=dev) // g)[None, None, :, None]
    m = torch.full((bsz, hkv, r, 1), MASK, dtype=torch.float32, device=dev)
    l = torch.zeros((bsz, hkv, r, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((bsz, hkv, r, d), dtype=torch.float32, device=dev)
    for t in range(s // block_kv):
        sl = slice(t * block_kv, (t + 1) * block_kv)
        kt = dequant_tile(k[:, sl], None if k_scale is None else k_scale[:, sl])
        vt = dequant_tile(v[:, sl], None if v_scale is None else v_scale[:, sl])
        sc = torch.einsum("bhrd,bkhd->bhrk", qf, kt) * scale
        kv_pos = (t * block_kv
                  + torch.arange(block_kv, device=dev))[None, None, None, :]
        valid = (kv_pos <= off + row_tok) & (row_tok < cl)
        sc = torch.where(valid, sc, MASK)
        m_new = torch.maximum(m, torch.amax(sc, dim=-1, keepdim=True))
        p = torch.exp(sc - m_new)
        corr = torch.exp(m - m_new)
        l_new = l * corr + torch.sum(p, dim=-1, keepdim=True)
        acc_new = acc * corr + torch.einsum("bhrk,bkhd->bhrd", p, vt)
        live = t * block_kv < total
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
        acc = torch.where(live, acc_new, acc)
    out = acc / torch.clamp_min(l, 1e-30)
    out = torch.where(row_tok < cl, out, 0.0)
    return out.reshape(bsz, hkv, c, g, d).to(q.dtype)


def flash_prefill(q, k, v, offset, chunk_len, k_scale=None, v_scale=None, *,
                  scale: Optional[float] = None, block_kv: int = 128):
    """Plain version (tiles of ``block_kv``) for CPU tensors, the CUDA
    kernel (its own tiling) for CUDA tensors."""
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, offset, chunk_len, k_scale,
                                   v_scale, scale=scale, block_kv=block_kv)
    bsz, hkv, c, g, d = q.shape
    s = k.shape[1]
    int8 = check_cache("flash_prefill", q, k, v, k_scale, v_scale)
    if k.shape != (bsz, s, hkv, d):
        raise ValueError(f"flash_prefill: cache {tuple(k.shape)} does not "
                         f"match q {tuple(q.shape)}")
    offset = offset.to(device=q.device, dtype=torch.int32).contiguous()
    chunk_len = chunk_len.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    scale = scale if scale is not None else d ** -0.5
    _lib.launch("flash_prefill", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                _lib.ptr(k_scale), _lib.ptr(v_scale), offset.data_ptr(),
                chunk_len.data_ptr(), out.data_ptr(), bsz, s, hkv, c, g, d,
                float(scale), int(int8))
    return out
