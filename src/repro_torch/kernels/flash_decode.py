"""One-token GQA decode attention over the KV cache as stored, linear or
paged.

``flash_decode_plain`` and ``flash_decode_paged_plain`` are the plain
PyTorch versions of the reference's tile-structured ``flash_decode_ref``
and ``flash_decode_paged_ref`` (per-tile dequant -> scores -> mask ->
online-softmax update, masked state updates for tiles past ``cur_len``);
they hold one float tile of the cache at a time.  ``flash_decode`` and
``flash_decode_paged`` run them for CPU tensors and launch
``csrc/flash_decode.cu`` for CUDA tensors.

Layouts: q (B, Hkv, G, D).  Linear cache: k/v (B, S, Hkv, Dk).  Paged
cache: pools (P, page_size, Hkv, Dk) and page_table (B, max_pages) int32
(-1 unallocated).  Formats, told apart by the scales: kv16 float values
(no scales, Dk = D); kv8 int8 codes (Dk = D) with float32 scales
(..., Hkv); kv4 packed nibbles (Dk = D // 2) with bf16 scales
(..., Hkv, D // 32), one rank above kv8's.  cur_len (B,) int32.  Returns
(B, Hkv, G, D); a cur_len == 0 row is zeros.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.quantize_pack import KV_BLOCK, kv4_dequant

MASK = -1e30


def kv_bits_of(k: torch.Tensor, k_scale: Optional[torch.Tensor]) -> int:
    """The cache format: 4 when the scale has the codes' rank, 8 with a
    scale one rank below, 16 without scales."""
    if k_scale is None:
        return 16
    return 4 if k_scale.ndim == k.ndim else 8


def dequant_tile(k: torch.Tensor, k_scale: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """A cache slice in float32: kv4 codes times their block scales, int8
    codes times their (token, head) scale, or the float values."""
    if k_scale is not None and k_scale.ndim == k.ndim:
        return kv4_dequant(k, k_scale)
    kt = k.to(torch.float32)
    if k_scale is not None:
        kt = kt * k_scale[..., None]
    return kt


def cache_tiles(k, v, k_scale, v_scale, *, block_kv: int = 0,
                page_table: Optional[torch.Tensor] = None):
    """(first position, float K tile, float V tile) in walk order: tiles of
    ``block_kv`` positions of a linear cache, or one page per tile of a
    pool, gathered through ``page_table`` (a -1 entry gathers page 0; its
    positions lie past the valid prefix and are masked)."""
    def sc(t, idx):
        return None if t is None else t[idx]

    if page_table is None:
        s = k.shape[1]
        if s % block_kv:
            raise ValueError(f"S={s} is not a multiple of block_kv={block_kv}")
        for t in range(s // block_kv):
            sl = (slice(None), slice(t * block_kv, (t + 1) * block_kv))
            yield (t * block_kv, dequant_tile(k[sl], sc(k_scale, sl)),
                   dequant_tile(v[sl], sc(v_scale, sl)))
        return
    ps = k.shape[1]
    for t in range(page_table.shape[1]):
        pages = torch.clamp_min(page_table[:, t], 0).long()
        yield (t * ps, dequant_tile(k[pages], sc(k_scale, pages)),
               dequant_tile(v[pages], sc(v_scale, pages)))


def attend_plain(qf, tiles, scale, valid, live):
    """The reference's online softmax over ``tiles``: qf (B, Hkv, R, D)
    float32; ``valid(pos)`` masks scores (B, Hkv, R, T) by position,
    ``live(start)`` (B, Hkv, R, 1) keeps a tile's state update.  Returns
    acc / l (B, Hkv, R, D)."""
    bsz, hkv, r, d = qf.shape
    dev = qf.device
    m = torch.full((bsz, hkv, r, 1), MASK, dtype=torch.float32, device=dev)
    l = torch.zeros((bsz, hkv, r, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((bsz, hkv, r, d), dtype=torch.float32, device=dev)
    for start, kt, vt in tiles:
        sc = torch.einsum("bhrd,bkhd->bhrk", qf, kt) * scale
        pos = start + torch.arange(kt.shape[1], device=dev)
        sc = torch.where(valid(pos[None, None, None, :]), sc, MASK)
        m_new = torch.maximum(m, torch.amax(sc, dim=-1, keepdim=True))
        p = torch.exp(sc - m_new)
        corr = torch.exp(m - m_new)
        l_new = l * corr + torch.sum(p, dim=-1, keepdim=True)
        acc_new = acc * corr + torch.einsum("bhrk,bkhd->bhrd", p, vt)
        keep = live(start)
        m = torch.where(keep, m_new, m)
        l = torch.where(keep, l_new, l)
        acc = torch.where(keep, acc_new, acc)
    return acc / torch.clamp_min(l, 1e-30)


def _decode_plain(q, tiles, cur_len, scale):
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    cur = cur_len.to(torch.int32)[:, None, None, None]
    out = attend_plain(q.to(torch.float32), tiles, scale,
                       lambda pos: pos < cur, lambda start: start < cur)
    return out.to(q.dtype)


def flash_decode_plain(q, k, v, cur_len, k_scale=None, v_scale=None, *,
                       scale: Optional[float] = None, block_kv: int = 128):
    return _decode_plain(q, cache_tiles(k, v, k_scale, v_scale,
                                        block_kv=block_kv), cur_len, scale)


def flash_decode_paged_plain(q, k_pool, v_pool, page_table, cur_len,
                             k_scale=None, v_scale=None, *,
                             scale: Optional[float] = None):
    return _decode_plain(q, cache_tiles(k_pool, v_pool, k_scale, v_scale,
                                        page_table=page_table), cur_len, scale)


def check_cache(name, q, k, v, k_scale, v_scale) -> int:
    """Shared wrapper checks of the flash kernels; returns the format code
    (16, 8 or 4).  Leading cache dims are the caller's to check."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    if q.dtype != torch.float32:
        raise ValueError(f"{name} kernel takes float32 q, got {q.dtype}")
    d = q.shape[-1]
    bits = kv_bits_of(k, k_scale)
    if (k_scale is None) != (v_scale is None):
        raise ValueError(f"{name}: give both scales or neither")
    if bits == 4:
        if (d % KV_BLOCK or k.dtype != torch.int8 or v.dtype != torch.int8
                or k_scale.dtype != torch.bfloat16
                or v_scale.dtype != torch.bfloat16
                or k_scale.shape != k.shape[:-1] + (d // KV_BLOCK,)
                or v_scale.shape != v.shape[:-1] + (d // KV_BLOCK,)):
            raise ValueError(f"{name}: kv4 needs int8 nibbles (..., Hkv, "
                             f"D/2) and bf16 scales (..., Hkv, D/32), "
                             f"D % 32 == 0")
    elif bits == 8:
        if (k.dtype != torch.int8 or v.dtype != torch.int8
                or k_scale.dtype != torch.float32
                or v_scale.dtype != torch.float32
                or k_scale.shape != k.shape[:-1]
                or v_scale.shape != v.shape[:-1]):
            raise ValueError(f"{name}: kv8 needs int8 codes (..., Hkv, D) "
                             f"and float32 scales (..., Hkv)")
    elif k.dtype != torch.float32 or v.dtype != torch.float32:
        raise ValueError(f"{name} kernel takes a float32 or int8 cache, got "
                         f"{k.dtype}")
    dk = d // 2 if bits == 4 else d
    if k.shape != v.shape or k.shape[-1] != dk:
        raise ValueError(f"{name}: k/v (..., Hkv, {dk}) must match q's D={d}")
    if d > 256:
        raise ValueError(f"{name} kernel takes head_dim <= 256")
    tensors = (q, k, v) + ((k_scale, v_scale) if bits < 16 else ())
    _lib.check_cuda(name, *tensors)
    return bits


def check_page_table(name, page_table, bsz, device) -> torch.Tensor:
    if page_table.ndim != 2 or page_table.shape[0] != bsz:
        raise ValueError(f"{name}: page_table must be (B, max_pages); got "
                         f"{tuple(page_table.shape)} for B={bsz}")
    return page_table.to(device=device, dtype=torch.int32).contiguous()


def flash_decode(q, k, v, cur_len, k_scale=None, v_scale=None, *,
                 scale: Optional[float] = None, block_kv: int = 128):
    """Plain version (tiles of ``block_kv``) for CPU tensors, the CUDA
    kernel (its own tiling) for CUDA tensors."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, cur_len, k_scale, v_scale,
                                  scale=scale, block_kv=block_kv)
    bsz, hkv, g, d = q.shape
    s = k.shape[1]
    bits = check_cache("flash_decode", q, k, v, k_scale, v_scale)
    if k.shape[:3] != (bsz, s, hkv):
        raise ValueError(f"flash_decode: cache {tuple(k.shape)} does not "
                         f"match q {tuple(q.shape)}")
    cur_len = cur_len.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    scale = scale if scale is not None else d ** -0.5
    _lib.launch("flash_decode", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                _lib.ptr(k_scale), _lib.ptr(v_scale), cur_len.data_ptr(),
                out.data_ptr(), bsz, s, hkv, g, d, float(scale), bits)
    return out


def flash_decode_paged(q, k_pool, v_pool, page_table, cur_len, k_scale=None,
                       v_scale=None, *, scale: Optional[float] = None):
    """Plain version (one page per tile) for CPU tensors, the CUDA kernel
    (tiles of 32 positions, each position's page looked up) for CUDA
    tensors."""
    if q.device.type == "cpu":
        return flash_decode_paged_plain(q, k_pool, v_pool, page_table,
                                        cur_len, k_scale, v_scale,
                                        scale=scale)
    bsz, hkv, g, d = q.shape
    bits = check_cache("flash_decode_paged", q, k_pool, v_pool, k_scale,
                       v_scale)
    if k_pool.shape[2] != hkv:
        raise ValueError(f"flash_decode_paged: pool {tuple(k_pool.shape)} "
                         f"does not match q {tuple(q.shape)}")
    pt = check_page_table("flash_decode_paged", page_table, bsz, q.device)
    cur_len = cur_len.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    scale = scale if scale is not None else d ** -0.5
    _lib.launch("flash_decode_paged", q.data_ptr(), k_pool.data_ptr(),
                v_pool.data_ptr(), _lib.ptr(k_scale), _lib.ptr(v_scale),
                pt.data_ptr(), cur_len.data_ptr(), out.data_ptr(), bsz,
                k_pool.shape[1], pt.shape[1], hkv, g, d, float(scale), bits)
    return out
