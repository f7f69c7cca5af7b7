"""Mamba-2 (SSD, state-space duality; arXiv:2405.21060), the reference's
``models/mamba2.py`` in plain torch.

One block:

    u -> RMSNorm -> in_proj -> [z | xBC | dt]
    xBC -> causal depthwise conv1d (width 4) -> SiLU -> [x | B | C]
    y = SSD(x, dt, A, B, C) + D * x
    out = out_proj(RMSNormGated(y, z)),   u + out

The reference computes all of it outside any Pallas kernel, so plain torch
is its port.  ``ssd_chunked`` is the chunked scan: inside a chunk the
recurrence is a (chunk x chunk) masked product, across chunks a loop over
the chunk states carries the (heads, headdim, state) running state (the
reference's ``lax.scan``: T / chunk steps, 1 for a 256-token prefill at the
published chunk).  ``ssd_decode_step`` is the one-token recurrence.

Shapes: x (B, T, H, P); B, C (B, T, G, N); dt (B, T, H); A (H,) negative.
G state groups broadcast over H heads (H % G == 0).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import layers


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                state: Optional[torch.Tensor] = None) -> tuple:
    """Depthwise causal conv.  x (B, T, C); w (W, C).  Returns (y,
    new_state), the state the trailing (W - 1, C) inputs for streaming
    decode."""
    width = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], width - 1, x.shape[-1]),
                          dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                  # (B, T + W - 1, C)
    t = x.shape[1]
    y = xp[:, 0:t] * w[0]
    for i in range(1, width):
        y = y + xp[:, i:i + t] * w[i]
    return y + b, xp[:, -(width - 1):]


def _segsum(log_a: torch.Tensor) -> torch.Tensor:
    """L[i, j] = sum_{k=j+1..i} log_a[k] for i >= j, -inf above the
    diagonal.  log_a (..., T) -> (..., T, T)."""
    t = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                 device=log_a.device))
    return diff.masked_fill(~mask, float("-inf"))


def _rep_g(z: torch.Tensor, rep: int) -> torch.Tensor:
    """Broadcast (..., G, N) state groups to H = G * rep heads."""
    return z if rep == 1 else torch.repeat_interleave(z, rep, dim=-2)


def ssd_chunked(x, dt, a, b, c, chunk: int,
                initial_state: Optional[torch.Tensor] = None,
                bf16_intra: bool = False) -> tuple:
    """The chunked SSD scan.  x (B, T, H, P); dt (B, T, H) after softplus;
    a (H,) negative; b, c (B, T, G, N).  Returns (y (B, T, H, P),
    final_state (B, H, P, N) float32).

    T is padded to a chunk multiple with dt = 0: such steps decay by
    exp(0) = 1 and add nothing, so the final state and the first T outputs
    are those of the unpadded scan.  The intra-chunk products run in
    float32 unless ``bf16_intra`` (then in x's dtype); the decay and the
    recurrence always in float32."""
    bsz, t, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep = h // g
    t_orig = t
    pad = (-t) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
        t += pad
    nc = t // chunk
    f32 = torch.float32
    idt = x.dtype if bf16_intra else f32
    xc = x.reshape(bsz, nc, chunk, h, p).to(idt)
    dtc = dt.reshape(bsz, nc, chunk, h).to(f32)
    bc = _rep_g(b.reshape(bsz, nc, chunk, g, n).to(idt), rep)
    cc = _rep_g(c.reshape(bsz, nc, chunk, g, n).to(idt), rep)

    log_a = dtc * a.to(f32)                          # (B, nc, chunk, H)
    seg = _segsum(log_a.transpose(-1, -2))           # (B, nc, H, i, j)

    # intra-chunk: the attention-like masked product
    cb = torch.einsum("bzihn,bzjhn->bzhij", cc, bc).to(f32)
    m = cb * torch.exp(seg) * dtc.transpose(-1, -2)[:, :, :, None, :]
    y_intra = torch.einsum("bzhij,bzjhp->bzihp", m.to(idt), xc).to(f32)

    # each chunk's terminal state: sum_j exp(cs_last - cs_j) dt_j B_j x_j^T
    cs = torch.cumsum(log_a, dim=2)                  # (B, nc, chunk, H)
    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)
    s_chunk = torch.einsum("bzjh,bzjhn,bzjhp->bzhpn",
                           (decay_to_end * dtc).to(idt), bc, xc).to(f32)

    # the recurrence over the chunk states
    chunk_decay = torch.exp(torch.sum(log_a, dim=2))  # (B, nc, H)
    s = (torch.zeros((bsz, h, p, n), dtype=f32, device=x.device)
         if initial_state is None else initial_state.to(f32))
    s_prevs = []
    for z in range(nc):
        s_prevs.append(s)
        s = s * chunk_decay[:, z, :, None, None] + s_chunk[:, z]
    s_prev = torch.stack(s_prevs, 1)                 # (B, nc, H, P, N)

    # inter-chunk: y_i += C_i . (exp(cs_i) * S_prev)
    y_inter = torch.einsum("bzihn,bzih,bzhpn->bzihp", cc,
                           torch.exp(cs).to(idt), s_prev.to(idt)).to(f32)
    y = (y_intra + y_inter).reshape(bsz, t, h, p)[:, :t_orig]
    return y.to(x.dtype), s


def ssd_decode_step(x, dt, a, b, c, state) -> tuple:
    """One-token recurrence.  x (B, H, P); dt (B, H); b, c (B, G, N); state
    (B, H, P, N).  Returns (y (B, H, P), new_state float32)."""
    f32 = torch.float32
    rep = x.shape[1] // b.shape[1]
    bh = _rep_g(b, rep).to(f32)                      # (B, H, N)
    ch = _rep_g(c, rep).to(f32)
    dtf = dt.to(f32)
    da = torch.exp(dtf * a.to(f32))                  # (B, H)
    upd = torch.einsum("bh,bhn,bhp->bhpn", dtf, bh, x.to(f32))
    new_state = state.to(f32) * da[..., None, None] + upd
    y = torch.einsum("bhn,bhpn->bhp", ch, new_state)
    return y.to(x.dtype), new_state


def _gate_norm(p: dict, y: torch.Tensor, width: int, reduce=None,
               eps: float = 1e-6) -> torch.Tensor:
    """``gate_norm``, an RMSNorm over the whole ``width``-channel row, of
    ``y``, a rank's block of its channels: the block's float64 sum of
    squares summed over the ranks by ``reduce``, then divided by
    ``width`` (:func:`layers.apply_norm` when ``y`` is the whole row)."""
    if reduce is None:
        return layers.apply_norm(p, y, "rmsnorm", eps)
    yf = y.to(torch.float32)
    ss = reduce(torch.sum(yf * yf, dim=-1, keepdim=True,
                          dtype=torch.float64))
    mean = (ss / width).to(torch.float32)
    return (yf * torch.rsqrt(mean + eps)
            * p["scale"].to(torch.float32)).to(y.dtype)


def apply_mamba2_block(p: dict, u: torch.Tensor, cfg,
                       ssm_state: Optional[torch.Tensor] = None,
                       conv_state: Optional[torch.Tensor] = None,
                       decode: bool = False, reduce=None,
                       out=None) -> tuple:
    """The whole block, residual included.  Returns (out, new_ssm_state,
    new_conv_state).

    The widths are read from the leaves, so ``p`` may be a rank's heads of
    the block (:class:`repro_torch.sharding.Segments`: z, x, dt and the
    per-head leaves by heads, B / C whole or by groups, the conv channels
    to match): SSD is per head.  Then ``reduce`` sums over the ranks that
    hold the other heads (``gate_norm``'s sum of squares), and ``out(h,
    w)`` is the row-split ``out_proj`` product summed over them; both
    default to the unsharded block."""
    bsz, t, _ = u.shape
    hp, n = cfg.ssm_headdim, cfg.ssm_state
    h = p["a_log"].shape[-1]
    d_in = h * hp
    g = (p["conv_b"].shape[-1] - d_in) // (2 * n)
    hs = layers.apply_norm(p["norm"], u, cfg.norm)
    proj = hs @ p["in_proj"]
    z = proj[..., :d_in]
    xbc = proj[..., d_in:2 * d_in + 2 * g * n]
    dt_raw = proj[..., 2 * d_in + 2 * g * n:]

    xbc, new_conv = causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xbc = F.silu(xbc)
    x = xbc[..., :d_in].reshape(bsz, t, h, hp)
    b = xbc[..., d_in:d_in + g * n].reshape(bsz, t, g, n)
    c = xbc[..., d_in + g * n:].reshape(bsz, t, g, n)
    dt = F.softplus(dt_raw.to(torch.float32)
                    + p["dt_bias"].to(torch.float32))
    a = -torch.exp(p["a_log"].to(torch.float32))

    if decode:
        if t != 1:
            raise ValueError(f"a mamba2 decode step takes one token; got "
                             f"T={t}")
        y, new_state = ssd_decode_step(x[:, 0], dt[:, 0], a, b[:, 0],
                                       c[:, 0], ssm_state)
        y = y[:, None]
    else:
        y, new_state = ssd_chunked(x, dt, a, b, c, cfg.ssm_chunk, ssm_state,
                                   bf16_intra=cfg.ssd_bf16_intra)
    y = y + p["d_skip"].to(y.dtype)[None, None, :, None] * x
    y = y.reshape(bsz, t, d_in)
    y = _gate_norm(p["gate_norm"], y, cfg.d_inner, reduce) * F.silu(z)
    return (u + (y @ p["out_proj"] if out is None
                 else out(y, p["out_proj"])), new_state, new_conv)


def init_mamba2_state(cfg, batch: int, device="cpu", parts: int = 1
                      ) -> tuple:
    """(ssm (B, H, P, N) float32, conv (B, W - 1, conv_dim)) zeros; a
    rank's H / ``parts`` heads and their conv channels (B and C by groups
    where ``parts`` divides G, else whole)."""
    g = cfg.ssm_ngroups // parts if cfg.ssm_ngroups % parts == 0 \
        else cfg.ssm_ngroups
    conv_dim = cfg.d_inner // parts + 2 * g * cfg.ssm_state
    return (torch.zeros((batch, cfg.ssm_heads // parts, cfg.ssm_headdim,
                         cfg.ssm_state), dtype=torch.float32, device=device),
            torch.zeros((batch, cfg.conv_width - 1, conv_dim),
                        dtype=getattr(torch, cfg.dtype), device=device))
