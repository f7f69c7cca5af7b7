"""Affine equivalent-transformation parameters (the paper's contribution).

A transform at a linear layer's input is an invertible ``A`` (plus an
optional translation ``shift``)::

    y = x @ w = ((x - shift) @ inv(A)) @ (A @ w) + (bias + shift @ w)

``A @ w`` is what gets quantized; ``inv(A)`` and the shift merge away at
deployment (:mod:`repro_torch.core.equivalence`).

Kinds: ``full`` (a dense (h, h) matrix under the gradual mask),
``diagonal`` (an h-vector, OmniQuant's equivalent scale, merged into the
norm when activations are quantized) and ``headwise`` ((heads, head_dim,
head_dim) blocks at the v_proj -> out_proj boundary).  Weights are
``(in, out)`` and the transform left-multiplies them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import gradual_mask as gm


@dataclasses.dataclass(frozen=True)
class AffineSpec:
    """One transform site of a block."""
    name: str                  # "ln_attn", "vo", "ln_mlp"
    kind: str                  # "full", "diagonal" or "headwise"
    dim: int                   # full/diagonal: hidden size; headwise: head_dim
    num_heads: int = 1         # headwise only
    with_shift: bool = False   # learnable translation (Outlier Suppression+)


def smoothquant_diag(act_absmax: torch.Tensor, w_absmax: torch.Tensor,
                     migration: float = 0.5, eps: float = 1e-5
                     ) -> torch.Tensor:
    """Weight-side diagonal ``act_max^m / w_max^(1 - m)`` (paper §A.7)."""
    a = torch.clamp_min(act_absmax.to(torch.float32), eps) ** migration
    w = torch.clamp_min(w_absmax.to(torch.float32), eps) ** (1.0 - migration)
    return torch.clamp(a / w, 1e-5, 1e5)


def init_params(spec: AffineSpec, diag_init: Optional[torch.Tensor] = None,
                dtype=torch.float32, device=None) -> dict:
    """The learnable tensors of one site; full and headwise matrices start
    diagonal (strictly diagonally dominant)."""
    if diag_init is None:
        diag_init = torch.ones((spec.dim,), dtype=dtype, device=device)
    diag_init = diag_init.to(dtype)
    device = diag_init.device
    params: dict = {}
    if spec.kind == "diagonal":
        params["a_diag"] = diag_init.clone()
    elif spec.kind == "full":
        params["a"] = torch.diag(diag_init)
    elif spec.kind == "headwise":
        eye = torch.eye(spec.dim, dtype=dtype, device=device)
        params["a"] = eye.expand(spec.num_heads, -1, -1).clone()
    else:
        raise ValueError(spec.kind)
    if spec.with_shift:
        hidden = spec.dim if spec.kind != "headwise" \
            else spec.dim * spec.num_heads
        params["shift"] = torch.zeros((hidden,), dtype=dtype, device=device)
    return params


def effective_matrix(spec: AffineSpec, params: dict,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A* = A o GM (Eq. 7); a diagonal site ignores the mask."""
    if spec.kind == "diagonal":
        return params["a_diag"]
    a = params["a"]
    return a if mask is None else gm.apply_mask(a, mask)


def invert(spec: AffineSpec, a_eff: torch.Tensor) -> torch.Tensor:
    """inv(A*) in float32 by a solve against the identity (not ``inv``); per
    head for headwise sites, an elementwise reciprocal for diagonal ones."""
    a = a_eff.to(torch.float32)
    if spec.kind == "diagonal":
        return torch.ones_like(a) / a
    eye = torch.eye(spec.dim, dtype=torch.float32, device=a.device)
    return torch.linalg.solve(a, eye.expand_as(a))


def transform_weight(spec: AffineSpec, a_eff: torch.Tensor,
                     w: torch.Tensor) -> torch.Tensor:
    """w_t = A @ w (left-multiply along the input-features axis)."""
    if spec.kind == "diagonal":
        return a_eff[:, None] * w
    if spec.kind == "headwise":
        wh = w.reshape(spec.num_heads, spec.dim, -1)
        return torch.einsum("hij,hjo->hio", a_eff.to(w.dtype), wh
                            ).reshape(w.shape)
    return (a_eff.to(w.dtype) @ w.to(a_eff.dtype)).to(w.dtype)


def transform_activation(spec: AffineSpec, a_inv: torch.Tensor,
                         x: torch.Tensor,
                         shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x_t = (x - shift) @ inv(A) (right-multiply along features)."""
    if shift is not None:
        x = x - shift.to(x.dtype)
    if spec.kind == "diagonal":
        return x * a_inv.to(x.dtype)
    if spec.kind == "headwise":
        xh = x.reshape(*x.shape[:-1], spec.num_heads, spec.dim)
        out = torch.einsum("...hd,hde->...he", xh, a_inv.to(x.dtype))
        return out.reshape(x.shape)
    return x @ a_inv.to(x.dtype)


def shift_bias_correction(shift: torch.Tensor, w: torch.Tensor,
                          bias: Optional[torch.Tensor]) -> torch.Tensor:
    """bias' = bias + shift @ w (Eq. 4's ``b + delta W`` term)."""
    corr = shift.to(torch.float32) @ w.to(torch.float32)
    if bias is None:
        return corr.to(w.dtype)
    return (bias.to(torch.float32) + corr).to(w.dtype)
