"""RMSNorm and LayerNorm, rotary position embedding, the SwiGLU, GeGLU,
GELU and ReLU MLPs and the token cross entropy, as the reference computes
them (float32 math, result in the input's dtype)."""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

NORMS = ("rmsnorm", "layernorm")
GATED = ("swiglu", "geglu")  # MLPs with a gate weight beside the up weight


def _mean64(x: torch.Tensor) -> torch.Tensor:
    """Mean over the last axis, accumulated in float64 and rounded to
    float32.  A float32 reduction on the card sums in an order set by the
    tensor's shape, so a row normalised inside a prefill chunk could differ
    in its last bit from the same row alone (decode), and at a4 such a bit
    can move an activation code.  Summed in float64, the order's effect lies
    far below float32's rounding step and the rounded mean is the same for
    every row count."""
    return torch.mean(x, dim=-1, keepdim=True,
                      dtype=torch.float64).to(torch.float32)


def apply_norm(params: dict, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm / LayerNorm.  A ``bias`` entry is honoured for either kind
    (merging a shifted affine transform into an RMSNorm introduces one)."""
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        xhat = xf * torch.rsqrt(_mean64(xf * xf) + eps)
    elif kind == "layernorm":
        centred = xf - _mean64(xf)
        xhat = centred * torch.rsqrt(_mean64(centred * centred) + eps)
    else:
        raise ValueError(f"norm={kind!r}: use one of {NORMS}")
    out = xhat * params["scale"].to(torch.float32)
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


def mlp_hidden(lin: Callable[[str, str], torch.Tensor], act: str
               ) -> torch.Tensor:
    """The MLP's hidden activation from ``lin(weight key, bias key)``, the
    linear product of the MLP input with one of its weights: a gate and an
    up product for the gated MLPs (SwiGLU, GeGLU), the up product alone
    for GELU and ReLU (OPT).  Every forward of the port (float,
    calibration, baselines, packed) goes through it, so they name the same
    linears.  GELU is the tanh approximation, as the reference's
    ``jax.nn.gelu(approximate=True)``."""
    if act == "swiglu":
        return F.silu(lin("w_gate", "b_gate")) * lin("w_up", "b_up")
    if act == "geglu":
        return F.gelu(lin("w_gate", "b_gate"), approximate="tanh") \
            * lin("w_up", "b_up")
    if act == "gelu":
        return F.gelu(lin("w_up", "b_up"), approximate="tanh")
    if act == "relu":
        return F.relu(lin("w_up", "b_up"))
    raise ValueError(f"act={act!r}: use swiglu, geglu, gelu or relu")


def apply_mlp(params: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """The MLP; ``b_gate`` / ``b_up`` are honoured when present (a shifted
    transform merged into the MLP norm introduces them)."""

    def lin(w_key, b_key):
        y = x @ params[w_key]
        return y + params[b_key] if b_key in params else y

    return mlp_hidden(lin, act) @ params["w_down"]


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
