"""Merging affine transforms into neighbouring parameters (paper §3.3).

* a diagonal transform after an RMSNorm folds into the norm's scale (and a
  shift into a new bias),
* a per-head transform at v_proj -> out_proj folds ``inv(A)`` into
  ``wv`` and ``A`` into ``wo``,
* in weight-only mode a full transform after a norm deploys as the fused
  effective weight ``inv(A) @ Q(A @ W)`` (the fake-quant simulation).

Every function returns new tensors; nothing is mutated.
"""
from __future__ import annotations

from typing import Optional

import torch

_F32 = torch.float32


def merge_diag_into_norm(norm_scale: torch.Tensor,
                         norm_bias: Optional[torch.Tensor],
                         a_diag: torch.Tensor,
                         shift: Optional[torch.Tensor] = None
                         ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """norm(x) = g * xhat + beta, then (. - shift) / a:
    g' = g / a, beta' = (beta - shift) / a (an RMSNorm gains a bias when
    there is a shift)."""
    a = a_diag.to(_F32)
    g = norm_scale.to(_F32) / a
    beta = None
    if norm_bias is not None or shift is not None:
        b = torch.zeros_like(a) if norm_bias is None else norm_bias.to(_F32)
        if shift is not None:
            b = b - shift.to(_F32)
        beta = (b / a).to(norm_scale.dtype)
    return g.to(norm_scale.dtype), beta


def merge_diag_into_weight(w: torch.Tensor, a_diag: torch.Tensor
                           ) -> torch.Tensor:
    """diag(a) @ w: scale the weight's input rows."""
    return (a_diag.to(_F32)[:, None] * w.to(_F32)).to(w.dtype)


def merge_inv_into_producer(w_prev: torch.Tensor,
                            b_prev: Optional[torch.Tensor],
                            a_inv: torch.Tensor,
                            shift: Optional[torch.Tensor] = None
                            ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Fold (y - shift) @ inv(A) into y = u @ w_prev + b_prev:
    w' = w_prev @ inv(A), b' = (b_prev - shift) @ inv(A)."""
    ai = a_inv.to(_F32)
    w = w_prev.to(_F32) @ ai
    b = None
    if b_prev is not None or shift is not None:
        bb = (torch.zeros(w_prev.shape[-1], dtype=_F32, device=w.device)
              if b_prev is None else b_prev.to(_F32))
        if shift is not None:
            bb = bb - shift.to(_F32)
        b = (bb @ ai).to(w_prev.dtype)
    return w.to(w_prev.dtype), b


def merge_full_into_weight(w: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """A @ w (the consumer side of a full transform)."""
    return (a.to(_F32) @ w.to(_F32)).to(w.dtype)


def merge_headwise_into_v_o(wv: torch.Tensor, wo: torch.Tensor,
                            a: torch.Tensor, a_inv: torch.Tensor,
                            num_kv_heads: int, num_q_heads: int
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """wv' = wv @ blockdiag(inv(A)), wo' = blockdiag(A) @ wo, with one
    (head_dim, head_dim) matrix per KV head shared by its query group."""
    d_model, head_dim = wv.shape[0], a.shape[-1]
    group = num_q_heads // num_kv_heads
    wv_h = wv.reshape(d_model, num_kv_heads, head_dim).to(_F32)
    wv_t = torch.einsum("dkh,khe->dke", wv_h, a_inv.to(_F32))
    wo_h = wo.reshape(num_kv_heads, group, head_dim, -1).to(_F32)
    wo_t = torch.einsum("khe,kgeo->kgho", a.to(_F32), wo_h)
    return (wv_t.reshape(wv.shape).to(wv.dtype),
            wo_t.reshape(wo.shape).to(wo.dtype))


def fuse_effective_weight(w_q: torch.Tensor, a_inv: torch.Tensor
                          ) -> torch.Tensor:
    """W_eff = inv(A) @ Q(A @ W), ``w_q`` being the fake-quantized
    transformed weight."""
    return (a_inv.to(_F32) @ w_q.to(_F32)).to(w_q.dtype)


def merge_error(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                solve_dtype=torch.float32) -> torch.Tensor:
    """Mean squared error of (x @ inv(A)) @ (A @ w) against x @ w: the
    round-off of the inverse and the merge alone (paper Table 4)."""
    eye = torch.eye(a.shape[0], dtype=solve_dtype, device=a.device)
    a_inv = torch.linalg.solve(a.to(solve_dtype), eye)
    w_t = a.to(solve_dtype) @ w.to(solve_dtype)
    y_merged = (x.to(solve_dtype) @ a_inv) @ w_t
    y_ref = x.to(solve_dtype) @ w.to(solve_dtype)
    return torch.mean(torch.square(y_merged - y_ref))
