"""Griffin / RecurrentGemma's RG-LRU block (arXiv:2402.19427), the
reference's ``models/griffin.py`` in plain torch.

The temporal-mixing half of a recurrent block:

    x  = W_rec u_n;  gate = GeLU(W_gate u_n)
    x  = SiLU(causal_conv(x))
    r  = sigmoid(w_a * x + b_a)          (recurrence gate, per channel)
    i  = sigmoid(w_x * x + b_x)          (input gate, per channel)
    la = -c * softplus(Lambda) * r       (log recurrence coefficient, c = 8)
    h_t = exp(la_t) h_{t-1} + sqrt(1 - exp(2 la_t)) * (i_t * x_t)
    out = W_out (h * gate),   u + out

The reference computes it outside any Pallas kernel (``jax.lax
.associative_scan`` over the sequence), so plain torch is its port:
``rglru_scan`` is a log-depth scan by doubling (Hillis-Steele) over the
(a, b) pairs of h_t = a_t h_{t-1} + b_t, ceil(log2 T) elementwise steps
over the whole sequence, never a loop over T.  It composes the pairs in
another order than ``associative_scan``'s tree, so its float32 results
agree within rounding, not bit for bit.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.mamba2 import causal_conv

RG_LRU_C = 8.0


def _rglru_coeffs(p: dict, x: torch.Tensor) -> tuple:
    """Per-step (log_a, beta * i * x) of the diagonal recurrence, float32."""
    f32 = torch.float32
    xf = x.to(f32)
    r = torch.sigmoid(p["gate_a_w"].to(f32) * xf + p["gate_a_b"].to(f32))
    i = torch.sigmoid(p["gate_x_w"].to(f32) * xf + p["gate_x_b"].to(f32))
    log_a = -RG_LRU_C * F.softplus(p["lam"].to(f32)) * r
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return log_a, beta * i * xf


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t with h_{-1} = 0 along dim 1, by doubling:
    after the step of span k every position holds the composition of the
    (up to) 2k pairs ending at it.  (a, b) (B, T, D) -> h (B, T, D)."""
    t = a.shape[1]
    k = 1
    while k < t:
        a_prev, b_prev = a[:, :-k], b[:, :-k]
        b = torch.cat([b[:, :k], a[:, k:] * b_prev + b[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, k:] * a_prev], dim=1)
        k *= 2
    return b


def rglru_scan(p: dict, x: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> tuple:
    """The whole-sequence RG-LRU.  x (B, T, D) -> (y (B, T, D), last state
    (B, D) float32)."""
    log_a, b = _rglru_coeffs(p, x)
    a = torch.exp(log_a)
    if h0 is not None:
        # fold the initial state into the first step's additive term
        b = torch.cat([b[:, :1] + a[:, :1] * h0.to(torch.float32)[:, None],
                       b[:, 1:]], dim=1)
    h = linear_scan(a, b)
    return h.to(x.dtype), h[:, -1]


def rglru_step(p: dict, x: torch.Tensor, h_prev: torch.Tensor) -> tuple:
    """One decode step.  x (B, 1, D), h_prev (B, D) -> (y (B, 1, D), h)."""
    log_a, b = _rglru_coeffs(p, x)
    h = torch.exp(log_a[:, 0]) * h_prev.to(torch.float32) + b[:, 0]
    return h.to(x.dtype)[:, None], h


def apply_rglru_block(p: dict, u: torch.Tensor, cfg,
                      rnn_state: Optional[torch.Tensor] = None,
                      conv_state: Optional[torch.Tensor] = None,
                      decode: bool = False, out=None) -> tuple:
    """The temporal-mixing half of a recurrent block, residual included.
    Returns (out, new_rnn_state, new_conv_state).  ``p`` may hold a rank's
    block of the rnn channels (``w_rec`` / ``w_gate`` column-split, the
    conv, gates and ``lam`` per channel, ``w_out`` row-split): then
    ``out(h, w)`` is the row-split ``w_out`` product summed over the ranks
    (default ``h @ w``)."""
    hs = layers.apply_norm(p["norm"], u, cfg.norm)
    gate = F.gelu(hs @ p["w_gate"], approximate="tanh")
    x, new_conv = causal_conv(hs @ p["w_rec"], p["conv_w"], p["conv_b"],
                              conv_state)
    x = F.silu(x)
    if decode:
        y, new_state = rglru_step(p, x, rnn_state)
    else:
        y, new_state = rglru_scan(p, x, rnn_state)
    h = y * gate
    return (u + (h @ p["w_out"] if out is None else out(h, p["w_out"])),
            new_state, new_conv)


def init_rglru_state(cfg, batch: int, device="cpu", parts: int = 1
                     ) -> tuple:
    """(rnn (B, D_rnn) float32, conv (B, W - 1, D_rnn)) zeros; a rank's
    D_rnn / ``parts`` channels."""
    d = cfg.rnn_dim // parts
    return (torch.zeros((batch, d), dtype=torch.float32, device=device),
            torch.zeros((batch, cfg.conv_width - 1, d),
                        dtype=getattr(torch, cfg.dtype), device=device))
