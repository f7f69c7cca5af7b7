"""RMSNorm, rotary position embedding, the SwiGLU MLP and the token
cross entropy, as the reference computes them (float32 math, result in the
input's dtype)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def apply_norm(params: dict, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm; a ``bias`` entry is honoured (merging a shifted affine
    transform into the norm introduces one)."""
    if kind != "rmsnorm":
        raise NotImplementedError(f"norm={kind!r}: the port has rmsnorm "
                                  f"only (layernorm comes with OPT)")
    xf = x.to(torch.float32)
    # the mean accumulates in float64: a float32 reduction on the card sums
    # in an order set by the tensor's shape, so a row normalised inside a
    # prefill chunk could differ in its last bit from the same row alone
    # (decode), and at a4 such a bit can move an activation code.  Summed
    # in float64, the order's effect lies far below float32's rounding step
    # and the rounded mean is the same for every row count.
    var = torch.mean(xf * xf, dim=-1, keepdim=True,
                     dtype=torch.float64).to(torch.float32)
    out = xf * torch.rsqrt(var + eps) * params["scale"].to(torch.float32)
    if "bias" in params:
        out = out + params["bias"].to(torch.float32)
    return out.to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device=None
                     ) -> torch.Tensor:
    """Inverse frequencies (head_dim // 2,) float32; head_dim is even."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate pairs (x[..., 2i], x[..., 2i+1]).  x (B, T, H, D), positions
    broadcastable to (B, T)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1 = x[..., 0::2].to(torch.float32)
    x2 = x[..., 1::2].to(torch.float32)
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def apply_mlp(params: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """SwiGLU MLP; ``b_gate`` / ``b_up`` are honoured when present (a
    shifted transform merged into the MLP norm introduces them)."""
    if act != "swiglu":
        raise NotImplementedError(f"act={act!r}: the port has swiglu only "
                                  f"(relu and gelu come with OPT)")

    def lin(w_key, b_key):
        y = x @ params[w_key]
        return y + params[b_key] if b_key in params else y

    return (F.silu(lin("w_gate", "b_gate")) * lin("w_up", "b_up")) \
        @ params["w_down"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean softmax cross entropy in float32."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.to(torch.float32)
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)
