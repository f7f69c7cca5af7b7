"""One-token GQA decode attention over the linear cache as stored.

``flash_decode_plain`` is the plain PyTorch version of the reference's
tile-structured ``flash_decode_ref`` (per-tile dequant -> scores -> mask ->
online-softmax update, masked state updates for tiles past ``cur_len``);
it holds one float tile of the cache at a time.  ``flash_decode`` runs it
for CPU tensors and launches ``csrc/flash_decode.cu`` for CUDA tensors.

Layouts: q (B, Hkv, G, D); k/v (B, S, Hkv, D) int8 codes with
k_scale/v_scale (B, S, Hkv) float32 (kv8), or float (kv16); cur_len (B,)
int32.  Returns (B, Hkv, G, D); a cur_len == 0 row is zeros.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _lib

MASK = -1e30


def dequant_tile(k: torch.Tensor, k_scale: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """A cache slice in float32: int8 codes times their (token, head)
    scale, or the float values."""
    kt = k.to(torch.float32)
    if k_scale is not None:
        kt = kt * k_scale[..., None]
    return kt


def flash_decode_plain(q, k, v, cur_len, k_scale=None, v_scale=None, *,
                       scale: Optional[float] = None, block_kv: int = 128):
    bsz, hkv, g, d = q.shape
    s = k.shape[1]
    if s % block_kv:
        raise ValueError(f"S={s} is not a multiple of block_kv={block_kv}")
    scale = scale if scale is not None else d ** -0.5
    cur = cur_len.to(torch.int32)[:, None, None, None]
    qf = q.to(torch.float32)
    dev = q.device
    m = torch.full((bsz, hkv, g, 1), MASK, dtype=torch.float32, device=dev)
    l = torch.zeros((bsz, hkv, g, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((bsz, hkv, g, d), dtype=torch.float32, device=dev)
    for t in range(s // block_kv):
        sl = slice(t * block_kv, (t + 1) * block_kv)
        kt = dequant_tile(k[:, sl], None if k_scale is None else k_scale[:, sl])
        vt = dequant_tile(v[:, sl], None if v_scale is None else v_scale[:, sl])
        sc = torch.einsum("bhgd,bkhd->bhgk", qf, kt) * scale
        pos = t * block_kv + torch.arange(block_kv, device=dev)
        sc = torch.where(pos[None, None, None, :] < cur, sc, MASK)
        m_new = torch.maximum(m, torch.amax(sc, dim=-1, keepdim=True))
        p = torch.exp(sc - m_new)
        corr = torch.exp(m - m_new)
        l_new = l * corr + torch.sum(p, dim=-1, keepdim=True)
        acc_new = acc * corr + torch.einsum("bhgk,bkhd->bhgd", p, vt)
        live = t * block_kv < cur
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
        acc = torch.where(live, acc_new, acc)
    out = acc / torch.clamp_min(l, 1e-30)
    return out.to(q.dtype)


def check_cache(name, q, k, v, k_scale, v_scale) -> bool:
    """Shared wrapper checks of the two flash kernels; True for kv8."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    int8 = k_scale is not None
    if q.dtype != torch.float32:
        raise ValueError(f"{name} kernel takes float32 q, got {q.dtype}")
    if int8:
        if (k.dtype != torch.int8 or v.dtype != torch.int8
                or k_scale.dtype != torch.float32
                or v_scale.dtype != torch.float32
                or k_scale.shape != k.shape[:-1]
                or v_scale.shape != v.shape[:-1]):
            raise ValueError(f"{name}: kv8 needs int8 codes (B, S, Hkv, D) "
                             f"and float32 scales (B, S, Hkv)")
    elif k.dtype != torch.float32 or v.dtype != torch.float32:
        raise ValueError(f"{name} kernel takes a float32 or int8 cache, got "
                         f"{k.dtype}")
    if k.shape != v.shape or k.shape[-1] != q.shape[-1]:
        raise ValueError(f"{name}: k/v (B, S, Hkv, D) must match q's D")
    if q.shape[-1] > 256:
        raise ValueError(f"{name} kernel takes head_dim <= 256")
    tensors = (q, k, v) + ((k_scale, v_scale) if int8 else ())
    _lib.check_cuda(name, *tensors)
    return int8


def flash_decode(q, k, v, cur_len, k_scale=None, v_scale=None, *,
                 scale: Optional[float] = None, block_kv: int = 128):
    """Plain version (tiles of ``block_kv``) for CPU tensors, the CUDA
    kernel (its own tiling) for CUDA tensors."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, cur_len, k_scale, v_scale,
                                  scale=scale, block_kv=block_kv)
    bsz, hkv, g, d = q.shape
    s = k.shape[1]
    int8 = check_cache("flash_decode", q, k, v, k_scale, v_scale)
    if k.shape != (bsz, s, hkv, d):
        raise ValueError(f"flash_decode: cache {tuple(k.shape)} does not "
                         f"match q {tuple(q.shape)}")
    cur_len = cur_len.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    scale = scale if scale is not None else d ** -0.5
    _lib.launch("flash_decode", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                _lib.ptr(k_scale), _lib.ptr(v_scale), cur_len.data_ptr(),
                out.data_ptr(), bsz, s, hkv, g, d, float(scale), int(int8))
    return out
