"""Gradual Mask (GM), paper Eq. 6.

    GM_ij = 1      if i == j
          = alpha  if 0 < |i - j| <= ceil((e / t) * hidden)
          = 0      otherwise

The forward uses ``A* = A o GM``; autograd through the Hadamard product
gives Eq. 9's masked gradient, so entries outside the band stay frozen and
off-diagonal ones learn at an ``alpha``-damped rate.  A small enough
``alpha`` keeps ``A*`` strictly diagonally dominant, hence invertible
(Levy-Desplanques; the paper's Appendix A.2): :func:`dominance_margin`
measures it.

``band_width`` divides in float32, as the reference does: a float64
quotient can round to the other side of an exact band edge.
"""
from __future__ import annotations

import torch


def band_width(epoch: int, total_epochs: int, hidden: int,
               device=None) -> torch.Tensor:
    """Number of unfrozen off-diagonals at ``epoch`` of ``total_epochs``."""
    f32 = dict(dtype=torch.float32, device=device)
    frac = (torch.tensor(epoch, **f32)
            / torch.tensor(float(max(total_epochs, 1)), **f32))
    return torch.ceil(frac * hidden)


def _distance(hidden: int, device) -> torch.Tensor:
    idx = torch.arange(hidden, device=device)
    return (idx[:, None] - idx[None, :]).abs()


def gradual_mask(hidden: int, epoch: int, total_epochs: int, alpha: float,
                 dtype=torch.float32, device=None) -> torch.Tensor:
    """Dense (hidden, hidden) GM matrix for the given epoch."""
    dist = _distance(hidden, device)
    bw = band_width(epoch, total_epochs, hidden, device)
    one, a, zero = (torch.tensor(v, dtype=dtype, device=device)
                    for v in (1.0, alpha, 0.0))
    return torch.where(dist == 0, one, torch.where(dist <= bw, a, zero))


def gradual_mask_headwise(hidden: int, num_heads: int, epoch: int,
                          total_epochs: int, alpha: float,
                          dtype=torch.float32, device=None) -> torch.Tensor:
    """GM confined to the per-head diagonal blocks: the band grows to
    ``hidden // num_heads`` inside a head and is 0 across heads."""
    if hidden % num_heads != 0:
        raise ValueError(f"hidden={hidden} not divisible by heads={num_heads}")
    head_dim = hidden // num_heads
    idx = torch.arange(hidden, device=device)
    same_head = (idx[:, None] // head_dim) == (idx[None, :] // head_dim)
    dist = _distance(hidden, device)
    bw = band_width(epoch, total_epochs, head_dim, device)
    one, a, zero = (torch.tensor(v, dtype=dtype, device=device)
                    for v in (1.0, alpha, 0.0))
    return torch.where(dist == 0, one,
                       torch.where((dist <= bw) & same_head, a, zero))


def apply_mask(a: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """A* = A o GM (Eq. 7); broadcasts over a leading head axis."""
    return a * mask


def dominance_margin(a: torch.Tensor) -> torch.Tensor:
    """min_i (|a_ii| - sum_{j != i} |a_ij|) over the last two axes (and
    any leading ones); > 0 <=> strictly diagonally dominant."""
    abs_a = a.abs()
    diag = torch.diagonal(abs_a, dim1=-2, dim2=-1)
    return torch.min(diag - (abs_a.sum(-1) - diag))


def is_strictly_diagonally_dominant(a: torch.Tensor) -> bool:
    return bool(dominance_margin(a) > 0)
