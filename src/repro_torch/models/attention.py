"""Attention of the float path: GQA under a causal, sliding-window,
prefix-LM or bidirectional mask (``mask_bias``, the reference's
``_mask_bias``).

q (B, T, Hq, D), k/v (B, T, Hkv, D); q is viewed as (B, T, Hkv, G, D) so
K/V are never repeated.  ``dense_attention`` materialises the (B, Hkv, G,
T, T) scores, as the reference's does; above ``CHUNK_THRESHOLD`` positions
(with T and S multiples of the blocks) ``attention`` runs
``chunked_attention``, the reference's online-softmax recurrence over
blocks of 1024 positions, which bounds the scores to one block pair.  Both
are plain torch, as the reference's are plain jnp.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
CHUNK_THRESHOLD = 8192      # the reference's attn_chunk_threshold
BLOCK = 1024                # its attn_block_q and attn_block_kv


def mask_bias(q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool = True,
              window: int = 0, prefix_len: int = 0) -> torch.Tensor:
    """(Tq, Skv) additive float32 mask: 0 where a query may attend, -1e30
    elsewhere.  ``causal`` admits kv_pos <= q_pos (and, with ``prefix_len
    > 0``, every position of the prefix: prefix-LM); ``window > 0`` also
    needs q_pos - kv_pos < window; ``causal=False`` without a window admits
    everything (a bidirectional encoder)."""
    ok = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        c = q_pos[:, None] >= kv_pos[None, :]
        if prefix_len > 0:
            c = c | (kv_pos[None, :] < prefix_len)
        ok = ok & c
    if window > 0:
        ok = ok & (q_pos[:, None] - kv_pos[None, :] < window)
    zero, neg = (torch.tensor(x, dtype=torch.float32, device=q_pos.device)
                 for x in (0.0, NEG_INF))
    return torch.where(ok, zero, neg)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    prefix_len: int = 0) -> torch.Tensor:
    b, t, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    qh = q.reshape(b, t, hkv, hq // hkv, d)
    scores = torch.einsum("bthgd,bshd->bhgts", qh, k).to(torch.float32) \
        * d ** -0.5
    scores = scores + mask_bias(torch.arange(t, device=q.device),
                                torch.arange(s, device=q.device), causal,
                                window, prefix_len)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgts,bshd->bthgd", probs.to(v.dtype), v)
    return out.to(q.dtype).reshape(b, t, hq, d)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      block_q: int = BLOCK, block_kv: int = BLOCK, *,
                      causal: bool = True, window: int = 0,
                      prefix_len: int = 0) -> torch.Tensor:
    """Flash-style attention under :func:`mask_bias`: per query block, a
    running (max, denominator, accumulator) over the KV blocks, in float32.  Needs
    T % block_q == 0 and S % block_kv == 0.  Every KV block is visited, as
    in the reference's scan (fully masked ones add exp(-1e30 - m) = 0)."""
    b, t, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    if t % block_q or s % block_kv:
        raise ValueError(f"chunked_attention needs T ({t}) and S ({s}) to be "
                         f"multiples of block_q ({block_q}) and block_kv "
                         f"({block_kv})")
    scale = d ** -0.5
    qh = q.reshape(b, t // block_q, block_q, hkv, g, d)
    kh = k.reshape(b, s // block_kv, block_kv, hkv, d)
    vh = v.reshape(b, s // block_kv, block_kv, hkv, d)
    f32 = dict(dtype=torch.float32, device=q.device)
    out = []
    for qi in range(t // block_q):
        q_pos = qi * block_q + torch.arange(block_q, device=q.device)
        m = torch.full((b, hkv, g, block_q), NEG_INF, **f32)
        den = torch.zeros((b, hkv, g, block_q), **f32)
        acc = torch.zeros((b, hkv, g, block_q, d), **f32)
        for ki in range(s // block_kv):
            kv_pos = ki * block_kv + torch.arange(block_kv, device=q.device)
            sc = torch.einsum("bqhgd,bkhd->bhgqk", qh[:, qi],
                              kh[:, ki]).to(torch.float32) * scale
            sc = sc + mask_bias(q_pos, kv_pos, causal, window, prefix_len)
            m_new = torch.maximum(m, torch.amax(sc, dim=-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            den = den * corr + torch.sum(p, dim=-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype),
                              vh[:, ki]).to(torch.float32)
            acc = acc * corr[..., None] + pv
            m = m_new
        blk = acc / torch.clamp_min(den, 1e-30)[..., None]
        out.append(torch.einsum("bhgqd->bqhgd", blk))
    return torch.stack(out, 1).reshape(b, t, hq, d).to(q.dtype)


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              prefix_len: int = 0) -> torch.Tensor:
    """Masked attention: dense up to ``CHUNK_THRESHOLD`` positions, chunked
    above it when the lengths are multiples of the blocks (the reference's
    dispatch)."""
    t, s = q.shape[1], k.shape[1]
    mask = dict(causal=causal, window=window, prefix_len=prefix_len)
    if max(t, s) > CHUNK_THRESHOLD and t % BLOCK == 0 and s % BLOCK == 0:
        return chunked_attention(q, k, v, **mask)
    return dense_attention(q, k, v, **mask)
