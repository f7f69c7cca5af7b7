"""Reference attention of the float path: causal GQA, no window.

q (B, T, Hq, D), k/v (B, T, Hkv, D); q is viewed as (B, T, Hkv, G, D) so
K/V are never repeated.  The (B, Hkv, G, T, T) scores are materialised,
as in the reference's ``dense_attention``; the reference switches to a
chunked online-softmax path above ``CHUNK_THRESHOLD`` positions, which the
port does not have yet.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
CHUNK_THRESHOLD = 8192      # the reference's attn_chunk_threshold


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> torch.Tensor:
    b, t, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    qh = q.reshape(b, t, hkv, hq // hkv, d)
    scores = torch.einsum("bthgd,bshd->bhgts", qh, k).to(torch.float32) \
        * d ** -0.5
    pos_q = torch.arange(t, device=q.device)
    pos_k = torch.arange(s, device=q.device)
    zero, neg = (torch.tensor(v, device=q.device) for v in (0.0, NEG_INF))
    scores = scores + torch.where(pos_q[:, None] >= pos_k[None, :], zero, neg)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgts,bshd->bthgd", probs.to(v.dtype), v)
    return out.to(q.dtype).reshape(b, t, hq, d)


def attention(q, k, v) -> torch.Tensor:
    """Causal dense attention up to ``CHUNK_THRESHOLD`` positions."""
    if max(q.shape[1], k.shape[1]) > CHUNK_THRESHOLD:
        raise NotImplementedError(
            f"{max(q.shape[1], k.shape[1])} positions: the reference runs "
            f"chunked_attention above {CHUNK_THRESHOLD}, which is not ported "
            f"yet (ROADMAP queue 1 item 7)")
    return dense_attention(q, k, v)
